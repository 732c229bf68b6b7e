"""``Trainer(offload="host")`` over a mesh, on two ranks (gloo on the
CPU), against the JAX package's 8-device virtual mesh.

A bf16 MLP (``Dense(16) → Dense(4)``, weights drawn with numpy and
carried by structural name) trains three SGD steps (momentum 0.9,
``multi_precision``) with its first weight sharded over ``tp`` and the
rest replicated, in the reference (``offload="host"``, mesh ``{'tp':
2}``) and on the ranks.  Each rank keeps the optimizer states' local
shards host-resident between steps (``memory.offload`` stashes each
shard and fetches it back as its ``DTensor``); an on-device mesh trainer
on the same weights is the oracle, which the offloaded trainer must
equal bit for bit.  Against the reference: weights within 1e-2 relative
and 1e-3 absolute (bf16 keeps 8 bits of mantissa; the two packages
reduce the f32 gradients in other orders).  ``save_states`` /
``load_states`` and ``save_checkpoint(sharded=True)`` / ``resume`` of
the offloaded trainer round-trip: a restored trainer's next step equals
the trainer that never stopped, bit for bit.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

X = np.random.RandomState(0).randn(4, 8).astype(np.float32)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
RULES = ((r"fc0_weight$", ("tp", None)), (r".*", ()))
STEPS = 3


def _net(mx, weights, ctx=None):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8, prefix="fc0_"),
                nn.Dense(4, in_units=16, prefix="fc1_"))
    if ctx is None:
        net.initialize(mx.init.Zero())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[k]))
    else:
        from mxnet_tpu_torch.convert import load_numpy_params

        load_numpy_params(net, weights, ctx=ctx)
    net.cast("bfloat16")
    return net


def _step(mx, net, trainer, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    x = mx.nd.array(X, **kw).astype("bfloat16")
    with mx.autograd.record():
        loss = (net(x).astype("float32") ** 2).mean()
    loss.backward()
    trainer.step(1)


def _weights(net):
    return {k: p.data().astype("float32").asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import checkpoint, gluon, parallel
    from mxnet_tpu_torch.memory import offload
    from mxnet_tpu_torch.parallel.local import is_dtensor

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r = parallel.rank()
    mesh = parallel.make_mesh({"tp": 2})
    out = {}

    def trainer(net, off):
        return gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                             partition_rules=RULES, mesh=mesh, offload=off)

    nets = [_net(tmx, w, cpu) for _ in range(2)]
    trs = [trainer(nets[0], None), trainer(nets[1], "host")]
    for s in range(STEPS):
        for net, tr in zip(nets, trs):
            _step(tmx, net, tr, cpu)
        out[f"equal.{s}"] = all(
            np.array_equal(a, b) for a, b in
            zip(_weights(nets[0]).values(), _weights(nets[1]).values()))
    # every state of the offloaded trainer is a host shard between steps
    arrs = [a for i in range(len(trs[1]._params))
            for a in trs[1]._offloaded_ndarrays(i)]
    out["stashed"] = all(offload.is_stashed(a) for a in arrs)
    out["plain_shards"] = not any(is_dtensor(a._data) for a in arrs)
    w0 = trs[1]._params[0]
    out["sharded_weight"] = is_dtensor(w0.data()._data) and \
        tuple(w0.data()._data.to_local().shape) == (8, 8)
    out["resident"] = offload.resident_bytes()
    for k, v in _weights(nets[1]).items():
        out["w." + k] = v
    # save_states / load_states round trip into a fresh offloaded trainer
    states = str(tmp / f"states{r}.bin")
    trs[1].save_states(states)
    fresh = _net(tmx, _weights(nets[1]), cpu)
    tr2 = trainer(fresh, "host")
    tr2.load_states(states)
    out["reload_stashed"] = all(
        offload.is_stashed(a) for i in range(len(tr2._params))
        for a in tr2._offloaded_ndarrays(i))
    # sharded checkpoint of the offloaded trainer, resumed into another
    ckpt = str(tmp / "ckpt")
    checkpoint.save_checkpoint(ckpt, STEPS, nets[1], trs[1], sharded=True)
    resumed = _net(tmx, w, cpu)
    tr3 = trainer(resumed, "host")
    step, _ = checkpoint.resume(ckpt, resumed, tr3)
    out["resume_step"] = step
    for net, tr in ((nets[1], trs[1]), (fresh, tr2), (resumed, tr3)):
        _step(tmx, net, tr, cpu)
    ref_next = _weights(nets[1])
    out["reload_equal"] = all(np.array_equal(ref_next[k], v)
                              for k, v in _weights(fresh).items())
    out["resume_equal"] = all(np.array_equal(ref_next[k], v)
                              for k, v in _weights(resumed).items())
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


@pytest.fixture(scope="module", autouse=True)
def _placement_reset():
    """The mesh trainers leave each package's mesh and placement summary
    (which step records read) set: reset them after the module."""
    yield
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel import partition as jpartition
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import partition

    for pkg, part in ((parallel, partition), (jpar, jpartition)):
        pkg.set_mesh(None)
        part._LAST_PLACEMENT = None


@pytest.fixture(scope="module")
def weights():
    rs = np.random.RandomState(1)
    return {"0.weight": rs.randn(16, 8).astype(np.float32) * 0.3,
            "0.bias": rs.randn(16).astype(np.float32) * 0.1,
            "1.weight": rs.randn(4, 16).astype(np.float32) * 0.3,
            "1.bias": rs.randn(4).astype(np.float32) * 0.1}


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("offload_mesh")
    np.savez(tmp / "weights.npz", **weights)
    return spawn(2, tmp, __file__, timeout=240, background=True)


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """The reference's offloaded trainer on its virtual mesh."""
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jpar

    mesh = jpar.make_mesh({"tp": 2})
    try:
        net = _net(jmx, weights)
        tr = jmx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                               partition_rules=RULES, mesh=mesh,
                               offload="host")
        for _ in range(STEPS):
            _step(jmx, net, tr)
        return _weights(net)
    finally:
        jpar.set_mesh(None)


def test_offloaded_mesh_trainer_equals_on_device_mesh_trainer(ranks):
    for out in ranks.result():
        assert all(bool(out[f"equal.{s}"]) for s in range(STEPS))
        assert bool(out["stashed"]) and bool(out["plain_shards"])
        assert bool(out["sharded_weight"])
        assert int(out["resident"]) > 0


def test_offloaded_mesh_trainer_weights_match_the_reference(ranks, ref):
    for out in ranks.result():
        for k, v in ref.items():
            np.testing.assert_allclose(out["w." + k], v, rtol=1e-2,
                                       atol=1e-3, err_msg=k)


def test_offloaded_mesh_trainer_states_round_trip(ranks):
    for out in ranks.result():
        assert bool(out["reload_stashed"])
        assert bool(out["reload_equal"])
        assert int(out["resume_step"]) == STEPS
        assert bool(out["resume_equal"])

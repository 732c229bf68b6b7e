"""Pipeline-parallel Llama of the port (``llama_pipeline_forward``, GPipe,
and ``llama_pipeline_train_step``, 1F1B) against the JAX package.

``llama_tiny`` (4 layers, f32, ``attn_mode="sdpa"``; tied and untied) is
built in the reference with Xavier weights, which cross to the port as
numpy arrays by structural name.  The reference runs its two entry
points on its ``{'pp': 4}`` virtual mesh (``tests/test_ring.py:161``,
``:267``, ``:321``): the loss, every parameter's gradient and one SGD
step after them.  The port runs the same on the local transport at
pp = 2 and 4 (here) and on gloo groups of four ranks
(``test_torch_parallel.spawn``): ``{'pp': 4}``, and ``{'dp': 2, 'pp':
2}`` with each dp rank its half of the batch and ``Trainer(kvstore=
"dist_sync")`` summing over dp only.  Every rank ends with every
parameter's gradient (the stage gradients are summed over pp), so the
weights after ``Trainer.step`` are the reference's on every rank.
Losses rtol 1e-5, gradients rtol 1e-4 atol 1e-5, weights rtol 1e-5 atol
1e-6.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

B, T, V, L, MB = 4, 16, 256, 4, 2
IDS = np.random.RandomState(0).randint(0, V, (B, T)).astype(np.int32)
LAB = np.random.RandomState(1).randint(0, V, (B, T)).astype(np.int32)
LR = 0.01
TIES = {"untied": False, "tied": True}


def _run(mx, net, fn, ids, lab, mesh, tokens):
    """One recorded pipeline loss (the mean over ``tokens``) and its
    backward through ``fn`` → (loss, {name: gradient})."""
    from importlib import import_module

    llama = import_module(type(net).__module__)
    with mx.autograd.record():
        if fn == "gpipe":
            logits = llama.llama_pipeline_forward(net, ids, MB, mesh=mesh)
            loss = mx.nd.softmax_cross_entropy(
                logits.reshape((-1, V)), lab.reshape((-1,))) / tokens
        else:
            loss = llama.llama_pipeline_train_step(net, ids, lab, MB,
                                                   mesh=mesh)
    loss.backward()
    return float(loss.asscalar()), {
        k: p.grad().asnumpy()
        for k, p in net._collect_params_with_prefix().items()
        if p.grad_req != "null"}


def _port_runs(weights, mesh, kvstore=None, rows=slice(None), batch=1):
    """Both entry points and a Trainer step through the port, tied and
    untied → {"<tie>.<fn>.loss"|".grad.<name>"|".step.<name>": value}."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    cpu = tmx.cpu()
    ids = nd.array(IDS[rows], ctx=cpu, dtype="int32")
    lab = nd.array(LAB[rows], ctx=cpu, dtype="int32")
    out = {}
    for tie, tied in TIES.items():
        net = llama.llama_tiny(num_layers=L, attn_mode="sdpa",
                               tie_embeddings=tied)
        load_numpy_params(net, weights[tie], ctx=cpu)
        for fn in ("gpipe", "1f1b"):
            loss, grads = _run(tmx, net, fn, ids, lab, mesh,
                               ids.shape[0] * T)
            out[f"{tie}.{fn}.loss"] = loss
            for k, g in grads.items():
                out[f"{tie}.{fn}.grad.{k}"] = g
        stage_fn = net._pp_machinery["stage_fn"]
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LR}, kvstore=kvstore)
        _run(tmx, net, "1f1b", ids, lab, mesh, ids.shape[0] * T)
        tr.step(batch)
        out[f"{tie}.same_stage_fn"] = \
            net._pp_machinery["stage_fn"] is stage_fn
        for k, p in net._collect_params_with_prefix().items():
            out[f"{tie}.step.{k}"] = p.data().asnumpy()
    return out


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    weights = {tie: dict(np.load(tmp / f"{tie}.npz")) for tie in TIES}
    parallel.initialize(ctx=tmx.cpu())
    r = parallel.rank()
    out = {f"pp4.{k}": v
           for k, v in _port_runs(weights, parallel.make_mesh(
               {"pp": 4})).items()}
    mesh = parallel.make_mesh({"dp": 2, "pp": 2})
    parallel.set_mesh(mesh)  # the store sums over this mesh's dp ranks
    half = mesh.get_local_rank("dp")
    out.update({f"dp2pp2.{k}": v for k, v in _port_runs(
        weights, mesh, kvstore="dist_sync",
        rows=slice(half * B // 2, (half + 1) * B // 2), batch=2).items()})
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


@pytest.fixture(scope="module")
def weights():
    import mxnet_tpu as jmx
    from mxnet_tpu.models import llama as jllama

    out = {}
    for tie, tied in TIES.items():
        jmx.random.seed(4)
        net = jllama.llama_tiny(num_layers=L, attn_mode="sdpa",
                                tie_embeddings=tied)
        net.initialize(jmx.init.Xavier())
        out[tie] = {k: p.data().asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}
    return out


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llama_pipeline")
    for tie in TIES:
        np.savez(tmp / f"{tie}.npz", **weights[tie])
    return spawn(4, tmp, __file__, timeout=240, background=True)


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """The reference's two entry points and a Trainer step on its
    {'pp': 4} virtual mesh."""
    import mxnet_tpu as jmx
    from mxnet_tpu import nd as jnd, parallel as jpar
    from mxnet_tpu.models import llama as jllama

    out = {}
    mesh = jpar.make_mesh({"pp": 4}, devices=None)
    with jpar.mesh_scope(mesh):
        ids = jnd.array(IDS, dtype="int32")
        lab = jnd.array(LAB, dtype="int32")
        for tie, tied in TIES.items():
            net = jllama.llama_tiny(num_layers=L, attn_mode="sdpa",
                                    tie_embeddings=tied)
            net.initialize()
            for k, p in net._collect_params_with_prefix().items():
                p.set_data(jnd.array(weights[tie][k]))
            for fn in ("gpipe", "1f1b"):
                loss, grads = _run(jmx, net, fn, ids, lab, None, B * T)
                out[f"{tie}.{fn}.loss"] = loss
                out[f"{tie}.{fn}.grad"] = grads
            tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": LR})
            _run(jmx, net, "1f1b", ids, lab, None, B * T)
            tr.step(1)
            out[f"{tie}.step"] = {
                k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}
    return out


@pytest.fixture(scope="module")
def local(weights, ref):
    return {pp: _port_runs(weights, {"pp": pp}) for pp in (2, 4)}


RUNS = ["local.pp2", "local.pp4", "ranks.pp4", "ranks.dp2pp2"]


def _outs(run, local, ranks):
    """Each run's results; ``dp2pp2``'s losses and gradients (each dp
    rank's are its half batch's means) averaged over the two dp ranks of
    each pp stage, which gives the whole batch's."""
    where, mesh = run.split(".")
    if where == "local":
        return [local[int(mesh[2:])]]
    outs = [{k[len(mesh) + 1:]: v for k, v in out.items()
             if k.startswith(mesh + ".")} for out in ranks.result()]
    if mesh != "dp2pp2":
        return outs
    # rank = 2·dp + pp: rank r's dp partner is r ^ 2
    return [{k: (a[k] + outs[r ^ 2][k]) / 2
             if ".loss" in k or ".grad." in k else a[k] for k in a}
            for r, a in enumerate(outs)]


@pytest.mark.parametrize("tie", sorted(TIES))
@pytest.mark.parametrize("fn", ["gpipe", "1f1b"])
@pytest.mark.parametrize("run", RUNS)
def test_pipeline_llama_matches_the_reference(ranks, ref, local, run, fn,
                                              tie):
    for out in _outs(run, local, ranks):
        np.testing.assert_allclose(out[f"{tie}.{fn}.loss"],
                                   ref[f"{tie}.{fn}.loss"], rtol=1e-5,
                                   atol=1e-6)
        want = ref[f"{tie}.{fn}.grad"]
        got = {k[len(f"{tie}.{fn}.grad."):]: v for k, v in out.items()
               if k.startswith(f"{tie}.{fn}.grad.")}
        assert got.keys() == want.keys()
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("tie", sorted(TIES))
@pytest.mark.parametrize("run", RUNS)
def test_trainer_step_after_the_pipeline_matches_the_reference(
        ranks, ref, local, run, tie):
    for out in _outs(run, local, ranks):
        assert bool(out[f"{tie}.same_stage_fn"])
        for k, w in ref[f"{tie}.step"].items():
            np.testing.assert_allclose(out[f"{tie}.step.{k}"], w, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_pipeline_llama_errors():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import llama

    net = llama.llama_tiny(num_layers=L)
    net.initialize(ctx=tmx.cpu())
    ids = nd.array(IDS, ctx=tmx.cpu(), dtype="int32")
    with pytest.raises(tmx.MXNetError, match="not divisible into 3 "
                                             "pipeline stages"):
        llama.llama_pipeline_forward(net, ids, 2, mesh={"pp": 3})
    with pytest.raises(tmx.MXNetError, match="batch 4 not divisible by 3 "
                                             "microbatches"):
        llama.llama_pipeline_train_step(net, ids, ids, 3, mesh={"pp": 2})
    with pytest.raises(tmx.MXNetError, match="no active mesh"):
        llama.llama_pipeline_forward(net, ids, 2)


if __name__ == "__main__":
    _worker(sys.argv[1])

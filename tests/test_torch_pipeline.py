"""The port's pipeline schedules (``parallel.pipeline_apply``, GPipe, and
``parallel.pipeline_train_1f1b``) against the JAX package.

The cases follow the reference's ``tests/test_ring.py``: a 4-stage
tanh-Dense pipeline over 6 microbatches against the stages back to back
(:96), its gradients (:119), the bad stack dimension (:154) and the 1F1B
step's loss, stage gradients, tail gradients and input cotangents (:219).
The same numpy inputs go through the reference on its ``{'pp': 4}``
virtual mesh (here, in the pytest process) and through the port twice:
over the local transport (every stage in this process, a ``{'pp': 4}``
dict mesh) and over a gloo group of four ranks (one stage a rank, point
to point; ``test_torch_parallel.spawn``), each rank with a wall clock.
Outputs rtol 1e-5, gradients rtol 1e-4, as the reference's tests.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

S, D, M, B = 4, 8, 6, 3
R = np.random.RandomState(1)
W = (R.randn(S, D, D) * 0.3).astype(np.float32)
BIAS = (R.randn(S, D) * 0.1).astype(np.float32)
XS = R.randn(M, B, D).astype(np.float32)
R = np.random.RandomState(7)
W1 = (R.randn(S, D, D) * 0.4).astype(np.float32)
LABELS = R.randn(M, B, D).astype(np.float32)
SCALE = np.float32(1.3).reshape(1)


def _port_cases(mesh):
    """Every case through the port on ``mesh`` → {name: numpy}."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, nd, parallel

    cpu = tmx.cpu()
    out = {}
    y = parallel.pipeline_apply(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        {"w": nd.array(W, ctx=cpu), "b": nd.array(BIAS, ctx=cpu)},
        nd.array(XS, ctx=cpu), mesh=mesh)
    out["gpipe.out"] = y.asnumpy()
    w = nd.array(W, ctx=cpu)
    xs = nd.array(XS, ctx=cpu)
    w.attach_grad()
    xs.attach_grad()
    with autograd.record():
        y = parallel.pipeline_apply(lambda p, x: torch.tanh(x @ p), w, xs,
                                    mesh=mesh)
        loss = (y * y).sum()
    loss.backward()
    out["gpipe.loss"] = loss.asnumpy()
    out["gpipe.dw"] = w.grad.asnumpy()
    out["gpipe.dx"] = xs.grad.asnumpy()
    try:
        parallel.pipeline_apply(lambda p, x: x, nd.ones((3, 2, 2), ctx=cpu),
                                nd.ones((2, 2, 2), ctx=cpu), mesh=mesh)
        out["bad_stack"] = ""
    except tmx.MXNetError as e:
        out["bad_stack"] = str(e)

    def loss_fn(o, lab, tail):
        return (((o * tail[0]) - lab) ** 2).sum()

    loss, grads, tgrads, dxs = parallel.pipeline_train_1f1b(
        lambda p, x: torch.tanh(x @ p), loss_fn, nd.array(W1, ctx=cpu),
        nd.array(XS, ctx=cpu), nd.array(LABELS, ctx=cpu),
        tail_params=(nd.array(SCALE, ctx=cpu),), mesh=mesh)
    out["1f1b.loss"] = loss.asnumpy()
    out["1f1b.grads"] = grads.asnumpy()
    out["1f1b.tail"] = tgrads[0].asnumpy()
    out["1f1b.dxs"] = dxs.asnumpy()
    return out


def _worker(tmp):
    import pathlib

    import torch

    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import pipeline

    torch.set_num_threads(1)
    parallel.initialize(ctx=__import__("mxnet_tpu_torch").cpu())
    mesh = parallel.make_mesh({"pp": S})
    out = _port_cases(mesh)
    out["transport"] = type(pipeline._transport(mesh, "pp")[1]).__name__
    np.savez(pathlib.Path(tmp) / f"rank{parallel.rank()}.npz", **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(S, tmp_path_factory.mktemp("pipeline"), __file__,
                 timeout=240, background=True)


@pytest.fixture(scope="module")
def ref(ranks):
    """The reference's cases on its {'pp': 4} virtual mesh."""
    import jax.numpy as jnp

    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag, nd as jnd, parallel as jpar

    out = {}
    mesh = jpar.make_mesh({"pp": S}, devices=None)
    with jpar.mesh_scope(mesh):
        out["gpipe.out"] = jpar.pipeline_apply(
            lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
            {"w": jnd.array(W), "b": jnd.array(BIAS)},
            jnd.array(XS)).asnumpy()
        w, xs = jnd.array(W), jnd.array(XS)
        w.attach_grad()
        xs.attach_grad()
        with jag.record():
            y = jpar.pipeline_apply(lambda p, x: jnp.tanh(x @ p), w, xs)
            loss = (y * y).sum()
        loss.backward()
        out["gpipe.loss"] = loss.asnumpy()
        out["gpipe.dw"] = w.grad.asnumpy()
        out["gpipe.dx"] = xs.grad.asnumpy()
        try:
            jpar.pipeline_apply(lambda p, x: x, jnd.ones((3, 2, 2)),
                                jnd.ones((2, 2, 2)))
        except jmx.MXNetError as e:
            out["bad_stack"] = str(e)

        def loss_fn(o, lab, tail):
            return jnp.sum(((o * tail[0]) - lab) ** 2)

        loss, grads, tgrads, dxs = jpar.pipeline_train_1f1b(
            lambda p, x: jnp.tanh(x @ p), loss_fn, jnd.array(W1),
            jnd.array(XS), jnd.array(LABELS),
            tail_params=(jnd.array(SCALE),))
        out["1f1b.loss"] = loss.asnumpy()
        out["1f1b.grads"] = grads.asnumpy()
        out["1f1b.tail"] = tgrads[0].asnumpy()
        out["1f1b.dxs"] = dxs.asnumpy()
    return out


@pytest.fixture(scope="module")
def local(ref):
    return _port_cases({"pp": S})


def _runs(ranks, local, transport):
    if transport == "local":
        return [local]
    runs = ranks.result()
    assert all(str(r["transport"]) == "P2PTransport" for r in runs)
    return runs


TRANSPORTS = ["local", "p2p"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_pipeline_matches_sequential(ranks, ref, local, transport):
    seq = XS.copy()
    for i in range(S):
        seq = np.tanh(seq @ W[i] + BIAS[i])
    for out in _runs(ranks, local, transport):
        np.testing.assert_allclose(out["gpipe.out"], seq, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["gpipe.out"], ref["gpipe.out"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_pipeline_backward(ranks, ref, local, transport):
    for out in _runs(ranks, local, transport):
        np.testing.assert_allclose(out["gpipe.loss"], ref["gpipe.loss"],
                                   rtol=1e-5)
        for k in ("gpipe.dw", "gpipe.dx"):
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_pipeline_bad_stack_dim(ranks, ref, local, transport):
    for out in _runs(ranks, local, transport):
        assert str(out["bad_stack"]) == ref["bad_stack"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_pipeline_1f1b_matches_reference(ranks, ref, local, transport):
    for out in _runs(ranks, local, transport):
        np.testing.assert_allclose(out["1f1b.loss"], ref["1f1b.loss"],
                                   rtol=1e-5)
        for k in ("1f1b.grads", "1f1b.tail", "1f1b.dxs"):
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_pipeline_errors_take_the_reference_wording(ref):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd, parallel

    x = nd.ones((2, 2, 2), ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError,
                       match="no active mesh; call parallel.set_mesh first"):
        parallel.pipeline_apply(lambda p, v: v, x, x)
    with pytest.raises(tmx.MXNetError, match="mesh has no 'pp' axis"):
        parallel.pipeline_train_1f1b(lambda p, v: v, None, x, x, x,
                                     mesh={"dp": 2})


def _tanh_loss(o, lab, tail):
    return (((o * tail[0]) - lab) ** 2).sum()


def test_1f1b_runs_the_last_stage_forward_once(ref):
    """Over the local transport a 1F1B step runs stages 0..S-2 twice a
    microbatch (the forward leg, then the recompute under autograd) and
    the last stage once (its forward leg only stashes the input), and
    its numbers stay the reference's."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd, parallel

    cpu = tmx.cpu()
    calls = {"no_grad": 0, "grad": 0}

    def stage_fn(p, x):
        calls["grad" if torch.is_grad_enabled() else "no_grad"] += 1
        return torch.tanh(x @ p)

    loss, grads, _, _ = parallel.pipeline_train_1f1b(
        stage_fn, _tanh_loss, nd.array(W1, ctx=cpu), nd.array(XS, ctx=cpu),
        nd.array(LABELS, ctx=cpu), tail_params=(nd.array(SCALE, ctx=cpu),),
        mesh={"pp": S})
    assert calls == {"no_grad": (S - 1) * M, "grad": S * M}
    np.testing.assert_allclose(loss.asnumpy(), ref["1f1b.loss"], rtol=1e-5)
    np.testing.assert_allclose(grads.asnumpy(), ref["1f1b.grads"],
                               rtol=1e-4, atol=1e-5)


def test_1f1b_stages_take_their_own_tensors(ref):
    """``train_1f1b_stages`` takes a list of S stage trees (each stage's
    own tensors, no stack) and gives each leaf its own gradient: the
    same numbers as the stacked entry point, a tree a stage; a list of
    the wrong length raises."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.parallel import pipeline

    ws = [{"w": [torch.tensor(W1[s])]} for s in range(S)]
    loss, grads, tgrads, dxs = pipeline.train_1f1b_stages(
        lambda p, x: torch.tanh(x @ p["w"][0]), _tanh_loss, ws,
        torch.tensor(XS), torch.tensor(LABELS),
        tail_params=(torch.tensor(SCALE),), mesh={"pp": S})
    assert len(grads) == S and all(set(g) == {"w"} for g in grads)
    ptrs = {g["w"][0].data_ptr() for g in grads}
    assert len(ptrs) == S and not ptrs & {w["w"][0].data_ptr() for w in ws}
    np.testing.assert_allclose(loss.numpy(), ref["1f1b.loss"], rtol=1e-5)
    np.testing.assert_allclose(
        np.stack([g["w"][0].numpy() for g in grads]), ref["1f1b.grads"],
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tgrads[0].numpy(), ref["1f1b.tail"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dxs.numpy(), ref["1f1b.dxs"], rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(tmx.MXNetError, match=f"must hold {S} stages"):
        pipeline.train_1f1b_stages(lambda p, x: x, _tanh_loss, ws[:2],
                                   torch.tensor(XS), torch.tensor(LABELS),
                                   mesh={"pp": S})


if __name__ == "__main__":
    _worker(sys.argv[1])

"""Ring and Ulysses attention of the port on four ranks (gloo on the
CPU) against dense attention and the JAX package's ``ring_attention``/
``ulysses_attention`` on its 8-device virtual mesh, with the same inputs.

One group of four ranks runs every case (``mxnet_tpu_torch.launch.run``)
over two meshes: ``{'sp': 4}`` and ``{'dp': 2, 'sp': 2}`` (sp = 4 and 2),
while the reference runs its cases at sp = 4 in the pytest process.
Forward causal and not (f32, atol 1e-5), the backward of
``sum(out * W)`` in q, k and v (atol 1e-4), and the refusals of an
indivisible sequence or head count, as the reference's
``tests/test_ring.py``.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

B, T, N, H = 2, 16, 4, 8
MESHES = {"sp4": {"sp": 4}, "sp2": {"dp": 2, "sp": 2}}
KINDS = ("ring", "ulysses")


def _inputs():
    r = np.random.RandomState(0)
    return [r.randn(B, T, N, H).astype(np.float32) for _ in range(4)]


def _dense(q, k, v, causal):
    logits = np.einsum("btnh,bsnh->bnts", q, k) / np.sqrt(q.shape[-1])
    if causal:
        keep = np.tril(np.ones((q.shape[1], k.shape[1]), bool))
        logits = np.where(keep[None, None], logits, -1e30)
    logits = logits - logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bnts,bsnh->btnh", p, v)


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, nd, parallel

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    q, k, v, w = _inputs()
    out = {}
    for mname, axes in MESHES.items():
        mesh = parallel.make_mesh(axes)
        for kind in KINDS:
            fn = getattr(parallel, f"{kind}_attention")
            for causal in (False, True):
                args = [parallel.shard_batch(nd.array(a, ctx=cpu), mesh,
                                             axis=1, axis_name="sp")
                        for a in (q, k, v)]
                for a in args:
                    a.attach_grad()
                with autograd.record():
                    o = fn(*args, causal=causal, mesh=mesh)
                    loss = (o * nd.array(w, ctx=cpu)).sum()
                loss.backward()
                key = f"{mname}.{kind}.{int(causal)}"
                out[key] = o.asnumpy()
                for name, a in zip("qkv", args):
                    out[f"{key}.d{name}"] = a.grad.asnumpy()
        # refusals
        for kind, shape in (("ring", (B, T - 1, N, H)),
                            ("ulysses", (B, T, 3, H))):
            x = nd.array(np.zeros(shape, np.float32), ctx=cpu)
            try:
                getattr(parallel, f"{kind}_attention")(x, x, x, mesh=mesh)
                out[f"{mname}.{kind}.refused"] = ""
            except tmx.MXNetError as e:
                out[f"{mname}.{kind}.refused"] = str(e)
    np.savez(tmp / f"rank{parallel.rank()}.npz", **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks, started in the background while the reference
    runs here."""
    return spawn(4, tmp_path_factory.mktemp("ring"), __file__,
                 background=True)


@pytest.fixture(scope="module")
def ref():
    """The reference's ring/ulysses on its mesh (sp=4), forward and the
    backward of sum(out * W); its result does not depend on sp, so the
    port's sp=2 runs are held to it too."""
    from mxnet_tpu import autograd as jag, nd as jnd, parallel as jpar

    q, k, v, w = _inputs()
    out = {}
    for sp in (4,):
        mesh = jpar.make_mesh({"sp": sp})
        for kind in KINDS:
            fn = getattr(jpar, f"{kind}_attention")
            for causal in (False, True):
                args = [jpar.shard_batch(jnd.array(a), mesh, axis=1,
                                         axis_name="sp")
                        for a in (q, k, v)]
                for a in args:
                    a.attach_grad()
                with jag.record():
                    o = fn(*args, causal=causal, mesh=mesh)
                    loss = (o * jpar.shard_batch(
                        jnd.array(w), mesh, axis=1, axis_name="sp")).sum()
                loss.backward()
                key = f"{sp}.{kind}.{int(causal)}"
                out[key] = o.asnumpy().astype(np.float32)
                out[key + ".grads"] = [a.grad.asnumpy() for a in args]
    return out


def _dense_grads(causal):
    import torch

    q, k, v, w = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in _inputs())
    logits = torch.einsum("btnh,bsnh->bnts", q, k) / np.sqrt(H)
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bnts,bsnh->btnh", torch.softmax(logits, -1), v)
    (o * w).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_dense_and_reference(ranks, ref, mname, kind,
                                             causal):
    q, k, v, _ = _inputs()
    dense = _dense(q, k, v, causal)
    for out in ranks.result():
        got = out[f"{mname}.{kind}.{int(causal)}"]
        np.testing.assert_allclose(got, dense, atol=1e-5)
        np.testing.assert_allclose(got, ref[f"4.{kind}.{int(causal)}"],
                                   atol=1e-5)


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_dense_and_reference(ranks, ref, mname, kind,
                                              causal):
    want = _dense_grads(causal)
    theirs = ref[f"4.{kind}.{int(causal)}.grads"]
    for out in ranks.result():
        for name, d, j in zip("qkv", want, theirs):
            got = out[f"{mname}.{kind}.{int(causal)}.d{name}"]
            np.testing.assert_allclose(got, d, atol=1e-4, err_msg=name)
            np.testing.assert_allclose(got, j, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_indivisible_sequence_or_heads_raise(ranks, mname):
    for out in ranks.result():
        assert "not divisible by sp" in str(out[f"{mname}.ring.refused"])
        assert "divisible by sp" in str(out[f"{mname}.ulysses.refused"])
        assert "heads" in str(out[f"{mname}.ulysses.refused"])


def test_raw_entry_without_sp_axis_is_the_flash_call():
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops import flash_attention as tfa
    from mxnet_tpu_torch.parallel import ring as tring

    tmx.parallel.set_mesh(None)
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  for a in _inputs())
    for fn in (tring.ring_attention_raw, tring.ulysses_attention_raw):
        torch.testing.assert_close(fn(q, k, v, causal=True),
                                   tfa.flash_attention_raw(q, k, v, True))


if __name__ == "__main__":
    _worker(sys.argv[1])

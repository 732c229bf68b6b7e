"""Serving on a mesh: ``GenerativeServer(mesh=, partition_rules=)`` of the
port against the JAX package's server on its virtual mesh.

``llama_tiny`` (f32) is built in the reference with Xavier weights, which
cross to the port as numpy arrays by structural name.  Four prompts of
5-12 tokens, 6 greedy tokens each, go through:

  * the reference's ``GenerativeServer`` without a mesh and on its
    virtual meshes ``{'tp': 2}``, ``{'dp': 2}`` and ``{'dp': 2, 'tp': 2}``
    (here, in the pytest process, while the ranks run);
  * the port with ``{'dp': 2}`` in this process (two replicas, one
    device each);
  * the port on gloo groups: two ranks at ``{'tp': 2}`` (one replica:
    the leader rank takes the requests, its peer runs what the leader
    sends), also with ``int8=True`` and in the slots mode, and four
    ranks at ``{'dp': 2, 'tp': 2}`` (two replicas; each leader takes its
    own requests).

Every reply equals the reference's token for token.  ``_split_mesh``'s
cases are held to the reference's replica count and width.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

PROMPTS = [np.random.RandomState(5).randint(1, 250, size=n)
           for n in (5, 9, 12, 7)]
NEW = 6


def _config(serving):
    return serving.ServerConfig(max_batch=2, max_length=64, min_length=8,
                                num_slots=2)


def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel, serving
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)
    r, n = parallel.rank(), parallel.world_size()
    net = llama.llama_tiny()
    load_numpy_params(net, dict(np.load(tmp / "weights.npz")), ctx=cpu)
    out = {}
    cases = [("tp2", {"tp": 2}, False, "paged"),
             ("tp2_int8", {"tp": 2}, True, "paged"),
             ("tp2_slots", {"tp": 2}, False, "slots")] \
        if n == 2 else [("dp2tp2", {"dp": 2, "tp": 2}, False, "paged")]
    for name, shape, int8, kv_mode in cases:
        mesh = parallel.make_mesh(shape)
        cfg = _config(serving)
        cfg.int8, cfg.kv_mode = int8, kv_mode
        srv = serving.GenerativeServer(net, cfg, mesh=mesh)
        eng = srv.engine
        out[name + ".q_shape"] = np.array(
            (eng._w["layers"][0]["q"]["q8"] if int8
             else eng._w["layers"][0]["q"]).shape)
        if int8:
            out[name + ".q_scale"] = np.array(
                eng._w["layers"][0]["q"]["scale"].shape)
            out[name + ".o_scale"] = np.array(
                eng._w["layers"][0]["o"]["scale"].shape)
        out[name + ".pool_shape"] = np.array(
            (eng._pool or eng._caches)[0][0].shape)
        with srv:
            out[name + ".leader"] = srv.serves_requests
            if not srv.serves_requests:
                try:
                    srv.submit(PROMPTS[0], max_new_tokens=NEW)
                except tmx.MXNetError as e:
                    out[name + ".refused"] = str(e)
                continue
            dp = mesh.get_local_rank("dp") if "dp" in shape else 0
            mine = [i for i in range(len(PROMPTS))
                    if i % shape.get("dp", 1) == dp]
            futs = {i: srv.submit(PROMPTS[i], max_new_tokens=NEW)
                    for i in mine}
            for i, f in futs.items():
                out[f"{name}.reply{i}"] = f.result(120)
    if n == 2:
        mesh = parallel.make_mesh({"tp": 2})
        for name, kw in (("spec", dict(draft_net=net, spec_k=2)),
                         ("radix", dict(radix_cache=True))):
            cfg = _config(serving)
            for k, v in kw.items():
                setattr(cfg, k, v)
            try:
                serving.GenerativeServer(net, cfg, mesh=mesh)
                out["refused." + name] = ""
            except tmx.MXNetError as e:
                out["refused." + name] = str(e)
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{r}.npz", **out)


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
    runs = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"serving_mesh{n}")
        np.savez(tmp / "weights.npz", **weights)
        runs[n] = spawn(n, tmp, __file__, timeout=240, background=True)
    return runs


def _ref_net(weights):
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.models import llama as jllama

    net = jllama.llama_tiny()
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jnd.array(weights[k]))
    return net


REF_MESHES = {"none": None, "tp2": ((2,), ("tp",)), "dp2": ((2,), ("dp",)),
              "dp2tp2": ((2, 2), ("dp", "tp"))}


@pytest.fixture(scope="module")
def ref(weights, ranks):
    """The reference server's replies without a mesh and on its virtual
    meshes (and at tp=2 with int8)."""
    import jax
    from jax.sharding import Mesh

    from mxnet_tpu import serving as jserving

    net = _ref_net(weights)
    out = {}
    for name, spec in REF_MESHES.items():
        mesh = None if spec is None else Mesh(
            np.array(jax.devices()[:int(np.prod(spec[0]))]).reshape(
                spec[0]), spec[1])
        for int8 in (False, True) if name == "tp2" else (False,):
            cfg = _config(jserving)
            cfg.int8 = int8
            with jserving.GenerativeServer(net, cfg, mesh=mesh) as srv:
                futs = [srv.submit(p, max_new_tokens=NEW) for p in PROMPTS]
                out[name + ("_int8" if int8 else "")] = [
                    f.result(120) for f in futs]
    return out


def _replies(outs, name):
    got = {}
    for out in outs:
        for i in range(len(PROMPTS)):
            if f"{name}.reply{i}" in out:
                assert i not in got
                got[i] = out[f"{name}.reply{i}"]
    return [got[i] for i in range(len(PROMPTS))]


@pytest.mark.parametrize("name,n", [("tp2", 2), ("tp2_int8", 2),
                                    ("tp2_slots", 2), ("dp2tp2", 4)])
def test_tensor_parallel_replies_equal_the_reference(ranks, ref, name, n):
    outs = ranks[n].result()
    want_of = ref["tp2" if name == "tp2_slots" else name]
    for got, want, plain in zip(_replies(outs, name), want_of,
                                ref["none"]):
        np.testing.assert_array_equal(got, want)
        if not name.endswith("int8"):
            np.testing.assert_array_equal(got, plain)
    leaders = [bool(o[name + ".leader"]) for o in outs]
    assert leaders == ([True, False] if n == 2 else
                       [True, False, True, False])
    for o in outs:
        if not bool(o[name + ".leader"]):
            assert "takes its requests" in str(o[name + ".refused"])


def test_tensor_parallel_layout_and_int8_leaves(ranks, weights):
    """Each tp rank holds half the q rows and half the KV heads; an int8
    leaf's q8 rows are sharded like the weight and its scales follow the
    output dim (sharded for q, whole for the row-parallel o)."""
    q = weights["model.layers.0.self_attn.q_proj.weight"]
    for o in ranks[2].result():
        assert o["tp2.q_shape"].tolist() == [q.shape[0] // 2, q.shape[1]]
        assert o["tp2_int8.q_shape"].tolist() == [q.shape[0] // 2,
                                                  q.shape[1]]
        assert o["tp2_int8.q_scale"].tolist() == [q.shape[0] // 2, 1]
        assert o["tp2_int8.o_scale"].tolist() == [q.shape[1], 1]
        assert o["tp2.pool_shape"][1] == 1  # llama_tiny's 2 KV heads / 2


def test_speculation_and_radix_on_a_tp_replica_name_their_list(ranks):
    for o in ranks[2].result():
        for name in ("spec", "radix"):
            assert "Left out of slice 12" in str(o["refused." + name])


def test_dp_replicas_in_one_process_equal_the_reference(weights, ref):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    net = llama.llama_tiny()
    load_numpy_params(net, weights, ctx=tmx.cpu())
    with serving.GenerativeServer(net, _config(serving),
                                  mesh={"dp": 2}) as srv:
        assert [r.engine.device.type for r in srv.replicas] == ["cpu"] * 2
        futs = [srv.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        got = [f.result(120) for f in futs]
        stats = srv.stats()
    assert stats["num_replicas"] == 2 and stats["completed"] == 4
    for g, w, plain in zip(got, ref["dp2"], ref["none"]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, plain)


def test_split_mesh_cases_match_the_reference():
    import jax
    from jax.sharding import Mesh

    import mxnet_tpu_torch as tmx
    from mxnet_tpu.serving.server import _split_mesh as jsplit
    from mxnet_tpu_torch.serving.server import _split_mesh

    cpu = tmx.cpu().device
    assert _split_mesh(None) == [None] and jsplit(None) == [None]
    for shape in ({"dp": 2}, {"dp": 2, "tp": 1}, {"tp": 1}, {"dp": 1}):
        dims = tuple(shape.values())
        jm = Mesh(np.array(jax.devices()[:int(np.prod(dims))]).reshape(
            dims), tuple(shape))
        want = jsplit(jm)
        got = _split_mesh(shape, device=cpu)
        assert len(got) == len(want), shape
        assert [r.tp for r in got] == [m.devices.size for m in want]
        assert all(r.device.type == "cpu" and r.local for r in got)
    with pytest.raises(tmx.MXNetError, match="one process a tp rank"):
        _split_mesh({"dp": 1, "tp": 2}, device=cpu)
    with pytest.raises(tmx.MXNetError, match="dp and tp axes only"):
        _split_mesh({"pp": 2}, device=cpu)


if __name__ == "__main__":
    _worker(sys.argv[1])

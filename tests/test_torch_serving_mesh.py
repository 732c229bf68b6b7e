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
    sends), also with ``int8=True``, in the slots mode, with speculative
    decoding (the net as its own draft) and with the radix cache (four
    prompts sharing a 20-token prefix), and four ranks at ``{'dp': 2,
    'tp': 2}`` (two replicas; each leader takes its own requests).

The speculative cases run twice: with the net as its own draft (every
proposal accepted) and with a draft of its own weights (the target's
plus seeded noise), whose rejected proposals roll the verify window,
the write cursors and the block tables back on both ranks.

Every reply equals the reference's token for token, and the speculative
and radix replies at tp = 2 equal tp = 1's, as do the speculative
requests' counts of proposals and acceptances.  ``_split_mesh``'s
cases are held to the reference's replica count and width.
"""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

PROMPTS = [np.random.RandomState(5).randint(1, 250, size=n)
           for n in (5, 9, 12, 7)]
NEW = 6
# the radix cache's prompts: a 20-token prefix (one 16-token block to
# share) and suffixes of 3-6 tokens; the first request runs alone, the
# rest reuse its block
_HEAD = np.random.RandomState(6).randint(1, 250, size=20)
RADIX_PROMPTS = [np.concatenate([_HEAD, np.random.RandomState(7 + i)
                                 .randint(1, 250, size=n)])
                 for i, n in enumerate((3, 6, 4, 5))]


def _config(serving, **kw):
    return serving.ServerConfig(max_batch=2, max_length=64, min_length=8,
                                num_slots=2, **kw)


def _spec_radix(net, draft):
    """(name, prompts, ServerConfig keywords) of the speculative cases (2
    proposals a window; the net as its own draft, then ``draft``) and the
    radix case."""
    return [("spec", PROMPTS, dict(draft_net=net, spec_k=2)),
            ("spec_draft", PROMPTS, dict(draft_net=draft, spec_k=2)),
            ("radix", RADIX_PROMPTS, dict(radix_cache=True))]


def _draft_weights(weights):
    """The draft's weights: the target's plus seeded noise of a third of
    each tensor's spread, so that it agrees with the target on some
    proposals and not on others."""
    rng = np.random.RandomState(11)
    return {k: (v + v.std() / 3 * rng.standard_normal(v.shape))
            .astype(v.dtype) for k, v in weights.items()}


def _serve_in_turn(srv, prompts):
    """The first prompt alone (its blocks enter the radix trie), then the
    rest together."""
    first = srv.submit(prompts[0], max_new_tokens=NEW).result(120)
    futs = [srv.submit(p, max_new_tokens=NEW) for p in prompts[1:]]
    return [first] + [f.result(120) for f in futs]


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
    draft = llama.llama_tiny()
    load_numpy_params(draft, dict(np.load(tmp / "draft.npz")), ctx=cpu)
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
        for name, prompts, kw in _spec_radix(net, draft):
            srv = serving.GenerativeServer(net, _config(serving, **kw),
                                           mesh=mesh)
            with srv:
                if srv.serves_requests:
                    for i, reply in enumerate(_serve_in_turn(srv, prompts)):
                        out[f"{name}.reply{i}"] = reply
                    out[name + ".records"] = json.dumps(
                        srv.request_records())
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
        np.savez(tmp / "draft.npz", **_draft_weights(weights))
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


@pytest.fixture(scope="module")
def tp1(weights):
    """The port's replies at tp = 1 (no mesh): plain, speculative and
    radix, on each case's prompts."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.convert import load_numpy_params
    from mxnet_tpu_torch.models import llama

    net = llama.llama_tiny()
    load_numpy_params(net, weights, ctx=tmx.cpu())
    draft = llama.llama_tiny()
    load_numpy_params(draft, _draft_weights(weights), ctx=tmx.cpu())
    out = {}
    for name, prompts, kw in _spec_radix(net, draft):
        for case, cfg in (("plain", _config(serving)),
                          (name, _config(serving, **kw))):
            with serving.GenerativeServer(net, cfg) as srv:
                out[f"{name}.{case}"] = _serve_in_turn(srv, prompts)
                recs = srv.request_records()
            if case == name:
                out[name + ".records"] = recs
    return out


def test_speculation_and_radix_on_a_tp_replica_name_their_list(ranks, tp1):
    """Speculative decoding and the radix cache on a tp = 2 replica (the
    draft's programs, the verify program and the radix cache's gather,
    suffix prefill and commit mirrored to the peer): the replies equal
    tp = 1's with the same option and plain greedy decoding's, token for
    token; the windows were scored and the prefix block reused.  The
    draft of its own weights had proposals rejected and others accepted,
    each request's counts as at tp = 1."""
    outs = ranks[2].result()
    leader = next(o for o in outs if "spec.reply0" in o)
    assert sum("spec.reply0" in o for o in outs) == 1
    for name, prompts in (("spec", PROMPTS), ("spec_draft", PROMPTS),
                          ("radix", RADIX_PROMPTS)):
        got = [leader[f"{name}.reply{i}"] for i in range(len(prompts))]
        for g, one, plain in zip(got, tp1[f"{name}.{name}"],
                                 tp1[f"{name}.plain"]):
            np.testing.assert_array_equal(g, one)
            np.testing.assert_array_equal(g, plain)
        recs = json.loads(str(leader[name + ".records"]))
        for want in (recs, tp1[name + ".records"]):
            if name.startswith("spec"):
                assert all(r["draft_tokens"] > 0 for r in want)
            else:
                assert [r["prefix_hit_tokens"] for r in want] == \
                    [0, 16, 16, 16]
        if name == "spec_draft":
            def counts(rs):
                return sorted((r["draft_tokens"], r["accepted_tokens"])
                              for r in rs)

            assert counts(recs) == counts(tp1[name + ".records"])
            drafted = sum(d for d, _ in counts(recs))
            accepted = sum(a for _, a in counts(recs))
            assert 0 < accepted < drafted - len(recs) * 2, counts(recs)


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

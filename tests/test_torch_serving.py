"""Serving of the PyTorch/CUDA port against the JAX package.

``llama_tiny`` is built in the JAX package (float32), its weights cross
as numpy arrays keyed by structural name (``convert.load_numpy_params``)
into the port's ``llama_tiny`` on the CPU, and the same seeded prompts
go through both packages' ``GenerativeServer`` and the JAX package's
offline ``generate``: token for token, in the paged mode with a late
join, the slots mode, speculative decoding (a same-net draft and a
rejecting one), the radix prefix cache and int8 weights.  The host-side
ledgers (block allocator, paged manager, radix trie) take the same
random operation sequence in both packages.  Every wait has a timeout.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import llama as jllama
from mxnet_tpu.serving import generative as jgen
from mxnet_tpu.serving import kv_cache as jkv
from mxnet_tpu.serving import radix as jradix

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.serving import generative as tgen
from mxnet_tpu_torch.serving import kv_cache as tkv
from mxnet_tpu_torch.serving import radix as tradix

CPU = tmx.cpu()
WAIT = 120          # seconds any one result may take
NEW = 8             # new tokens a request


def _pair():
    jnet = jllama.llama_tiny()
    jnet.initialize()
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    tnet = tllama.llama_tiny()
    load_numpy_params(tnet, arrays, ctx=CPU)
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net) with the same weights, and a draft pair with
    other weights (a draft that disagrees with the target)."""
    return _pair(), _pair()


def _prompts():
    rs = np.random.RandomState(7)
    sys_prompt = rs.randint(1, 250, size=20)
    plain = [rs.randint(1, 250, size=n) for n in (5, 9, 12)]
    shared = [np.concatenate([sys_prompt, rs.randint(1, 250, size=n)])
              for n in (4, 6, 3)]
    return plain + shared


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def oracle(nets):
    """The JAX package's offline greedy ``generate`` of every prompt."""
    (jnet, _), _ = nets
    return [jnet.generate(jmx.nd.array(p[None]), NEW).asnumpy()[0]
            .astype(np.int32) for p in PROMPTS]


def _config(pkg, **kw):
    return pkg.ServerConfig(max_batch=2, max_length=64, min_length=8,
                            num_slots=2, **kw)


def _serve(pkg, net, prompts, first=None, **kw):
    """Serve ``prompts``; with ``first``, the first ``first`` prompts
    finish before the rest are submitted (a deterministic order: the
    radix mode's sharers then always find their prefix committed)."""
    srv = pkg.GenerativeServer(net, _config(pkg, **kw))
    with srv:
        futs = [srv.submit(p, max_new_tokens=NEW)
                for p in prompts[:first]]
        outs = [f.result(WAIT) for f in futs]
        if first is not None:
            futs = [srv.submit(p, max_new_tokens=NEW)
                    for p in prompts[first:]]
            outs += [f.result(WAIT) for f in futs]
        stats = srv.stats()
    return outs, stats, srv


def _modes(nets):
    (jnet, tnet), (jdraft, tdraft) = nets
    return {
        "slots": ({"kv_mode": "slots"}, {"kv_mode": "slots"}),
        "spec_same_net": ({"draft_net": jnet, "spec_k": 3},
                          {"draft_net": tnet, "spec_k": 3}),
        "spec_rejecting": ({"draft_net": jdraft, "spec_k": 3},
                           {"draft_net": tdraft, "spec_k": 3}),
        "radix": ({"radix_cache": True, "block_size": 8},
                  {"radix_cache": True, "block_size": 8}),
    }


@pytest.mark.parametrize("mode", ["slots", "spec_same_net",
                                  "spec_rejecting", "radix"])
def test_server_modes_match_jax_server_and_generate(nets, oracle, mode):
    (jnet, tnet), _ = nets
    jkw, tkw = _modes(nets)[mode]
    # radix: the first prompt with the shared system prefix (index 3)
    # finishes before its two sharers arrive, in both servers
    first = 4 if mode == "radix" else None
    jouts, jstats, _ = _serve(jserving, jnet, PROMPTS, first, **jkw)
    touts, tstats, srv = _serve(tserving, tnet, PROMPTS, first, **tkw)
    for p, o, j, t in zip(PROMPTS, oracle, jouts, touts):
        assert t.dtype == np.int32 and t.shape == (len(p) + NEW,)
        np.testing.assert_array_equal(t, o)
        np.testing.assert_array_equal(t, j)
    assert tstats["completed"] == len(PROMPTS)
    assert tstats["kv_cache"]["occupancy"] == 0
    if mode.startswith("spec"):
        # the counts depend on which slots share each window (timing),
        # so only their kind is held against the reference's
        spec, jspec = tstats["speculative"], jstats["speculative"]
        assert spec["k"] == jspec["k"] == 3 and spec["draft_tokens"] > 0
        if mode == "spec_same_net":
            assert spec["accept_rate"] >= 0.6
        else:   # the rollback path ran
            assert spec["draft_tokens"] > spec["accepted_tokens"]
        sigs = tstats["compiled_signatures"]
        assert sigs.count(("verify",)) == 1 and \
            not [s for s in sigs if s[0] == "step"]
        srv.replicas[0].mgr.check()
    if mode == "radix":
        assert tstats["radix_cache"]["hits"] >= 2
        assert jstats["radix_cache"]["hits"] >= 2
        assert tstats["kv_cache"]["peak_shared_blocks"] >= 2
        hits = [r for r in srv.request_records()
                if r.get("prefix_hit_tokens")]
        assert len(hits) >= 2
        srv.replicas[0].mgr.check()


def test_paged_late_join_matches_jax_server_and_generate(nets):
    """The default mode: a late request is prefilled by the prefill lane
    and joins the in-flight decode; both replies equal the JAX server's
    and the JAX offline ``generate``, and the records show the join."""
    (jnet, tnet), _ = nets
    p1, p2 = PROMPTS[0], PROMPTS[1]
    srv = tserving.GenerativeServer(tnet, _config(tserving))
    with srv:
        f1 = srv.submit(p1, max_new_tokens=40)
        deadline = time.time() + WAIT
        while srv.engine.steps < 2 and time.time() < deadline:
            time.sleep(0.002)
        assert srv.engine.steps >= 2
        f2 = srv.submit(p2, max_new_tokens=4)
        r1, r2 = f1.result(WAIT), f2.result(WAIT)
        stats, health = srv.stats(), srv.health()
    jsrv = jserving.GenerativeServer(jnet, _config(jserving))
    with jsrv:
        j1 = jsrv.submit(p1, max_new_tokens=40)
        j2 = jsrv.submit(p2, max_new_tokens=4)
        j1, j2 = j1.result(WAIT), j2.result(WAIT)
    o1 = jnet.generate(jmx.nd.array(p1[None]), 40).asnumpy()[0]
    o2 = jnet.generate(jmx.nd.array(p2[None]), 4).asnumpy()[0]
    for got, jax_srv, off in ((r1, j1, o1), (r2, j2, o2)):
        np.testing.assert_array_equal(got, off)
        np.testing.assert_array_equal(got, jax_srv)
    recs = srv.request_records()
    assert [r["status"] for r in recs] == ["ok", "ok"]
    first, late = recs
    assert late["joined_step"] >= 2
    assert late["done_step"] < first["done_step"]
    assert all(r["lane"] == "decode" and r["kv_blocks"] >= 1 and
               r["handoff_ms"] >= 0 and r["ttft_ms"] > 0 for r in recs)
    assert stats["kv_cache"]["peak_occupancy"] == 2
    assert stats["kv_cache"]["occupancy"] == 0
    # one decode-step signature: (kv mode, slots, table width, dtype)
    assert [s for s in stats["compiled_signatures"] if s[0] == "step"] == \
        [("step", "paged", srv.engine.num_slots, srv.engine.max_blocks,
          "float32")]
    assert health["status"] == "ok" and health["running"]
    assert srv.health()["status"] == "stopped"


def test_int8_weights_and_tokens_match_jax(nets):
    """int8 weight-only quantization: the dequantized weights equal the
    JAX package's bit for bit, and the int8 servers agree token for
    token."""
    (jnet, tnet), _ = nets
    jw = jllama.LlamaDecoder(jnet, 64)._weights()
    tw = tllama.LlamaDecoder(tnet, 64)._weights()
    jd = jgen._dequantize_tree(jgen._quantize_tree(jw))
    td = tgen._dequantize_tree(tgen._quantize_tree(tw))
    tq = tgen._quantize_tree(tw)
    assert tq["layers"][0]["q"]["q8"].dtype == torch.int8
    pairs = [(jd["head"], td["head"])] + [
        (jl[k], tl[k]) for jl, tl in zip(jd["layers"], td["layers"])
        for k in tgen._QUANT_KEYS]
    for j, t in pairs:
        j = np.asarray(j)
        assert j.dtype == np.float32 and t.dtype == torch.float32
        np.testing.assert_array_equal(t.detach().numpy(), j)
    prompts = PROMPTS[:3]
    jouts, _, _ = _serve(jserving, jnet, prompts, int8=True)
    touts, _, srv = _serve(tserving, tnet, prompts, int8=True)
    assert srv.engine.int8
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t, j)


def test_int8_engine_keeps_no_f32_weight_tree(nets):
    """The int8 engine holds only int8 rows and their scales; each matmul
    dequantizes its own leaf, which gives the same bits as the product
    with the whole dequantized tree."""
    (_, tnet), _ = nets
    eng = tgen.LlamaServingEngine(tnet, max_len=64, num_slots=2,
                                  int8=True, kv_mode="paged", block_size=8)
    leaves = [eng._w["head"]] + [L[k] for L in eng._w["layers"]
                                 for k in tgen._QUANT_KEYS]
    assert all(set(leaf) == {"q8", "scale"} and
               leaf["q8"].dtype == torch.int8 for leaf in leaves)
    dense = tgen._dequantize_tree(eng._w)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, tnet.config.hidden_size).astype(np.float32))
    for k in ("q", "down"):
        leaf, w = eng._w["layers"][0][k], dense["layers"][0][k]
        x_k = x if w.shape[1] == x.shape[1] else torch.from_numpy(
            np.random.RandomState(4).randn(4, w.shape[1])
            .astype(np.float32))
        assert torch.equal(tllama._mm(x_k, leaf), tllama._mm(x_k, w))


def test_ledgers_match_jax_on_a_random_sequence():
    """The same random admit / advance / truncate / evict / share
    sequence through both packages' ``PagedKVCacheManager`` (with its
    ``BlockAllocator``) and ``RadixPrefixCache`` gives the same block
    ids, the same ``stats()`` and passes both ``check()``s; a slot
    ledger and a bare allocator likewise."""
    rs = np.random.RandomState(11)
    mgrs = [pkg.PagedKVCacheManager(num_slots=4, max_len=64, num_blocks=40,
                                    block_size=4) for pkg in (jkv, tkv)]
    rxs = [rmod.RadixPrefixCache(m.allocator, block_size=4,
                                 capacity_tokens=48)
           for rmod, m in zip((jradix, tradix), mgrs)]
    for m, rx in zip(mgrs, rxs):
        m.prefix_cache = rx
    stem = list(rs.randint(1, 50, size=12))
    active = {}
    for step in range(120):
        op = rs.randint(4)
        if op == 0 and len(active) < 4:
            n = int(rs.randint(1, 20))
            prompt = (stem if rs.rand() < 0.5 else []) + \
                list(rs.randint(1, 50, size=n))
            budget = int(rs.randint(1, 16))
            got = []
            for m, rx in zip(mgrs, rxs):
                matched, shared = rx.lookup(prompt)
                out = m.admit(f"r{step}", len(prompt), budget,
                              shared_blocks=shared or None)
                got.append((matched, out))
            assert got[0] == got[1]
            if got[0][1] is not None:
                slot, blocks = got[0][1]
                for m, rx in zip(mgrs, rxs):
                    m.state(slot).pos = len(prompt)
                    rx.insert(prompt, blocks)
                active[slot] = prompt
        elif op == 1 and active:
            slot = sorted(active)[rs.randint(len(active))]
            for m in mgrs:
                st = m.state(slot)
                if st.pos < st.reserved:
                    m.advance(slot)
                    m.consume(slot)
        elif op == 2 and active:
            slot = sorted(active)[rs.randint(len(active))]
            pos = mgrs[0].state(slot).pos
            back = int(rs.randint(0, 3))
            target = max(len(active[slot]), pos - back)
            assert mgrs[0].truncate(slot, target) == \
                mgrs[1].truncate(slot, target)
        elif op == 3 and active:
            slot = sorted(active)[rs.randint(len(active))]
            assert mgrs[0].evict(slot) == mgrs[1].evict(slot)
            del active[slot]
        assert mgrs[0].stats() == mgrs[1].stats()
        assert rxs[0].stats() == rxs[1].stats()
        assert mgrs[0].allocator._free == mgrs[1].allocator._free
        for m in mgrs:
            m.check()
    assert rxs[0].block_refs() == rxs[1].block_refs()
    ledgers = [pkg.KVCacheManager(3, 32) for pkg in (jkv, tkv)]
    for i in range(5):
        assert ledgers[0].admit(i, 4, 8) == ledgers[1].admit(i, 4, 8)
    ledgers[0].evict(1)
    ledgers[1].evict(1)
    assert ledgers[0].stats() == ledgers[1].stats()


def test_engine_programs_keep_the_reference_signature_keys(nets):
    """The engine notes each program shape it ran under the reference's
    keys, and the paged pool's bytes are the reference's (the trash
    block is not counted)."""
    (jnet, tnet), _ = nets
    j = jgen.LlamaServingEngine(jnet, max_len=64, num_slots=2,
                                kv_mode="paged", block_size=8)
    t = tgen.LlamaServingEngine(tnet, max_len=64, num_slots=2,
                                kv_mode="paged", block_size=8)
    assert t.kv_pool_bytes() == j.kv_pool_bytes()
    assert t._pool[0][0].shape[0] == t.num_blocks + 1
    ts = tgen.LlamaServingEngine(tnet, max_len=64, num_slots=2)
    js = jgen.LlamaServingEngine(jnet, max_len=64, num_slots=2)
    assert ts.kv_pool_bytes() == js.kv_pool_bytes()
    with pytest.raises(tmx.MXNetError):
        ts.verify(np.zeros((2, 2), np.int32))
    # mesh= is ported in slice 12 (test_torch_serving_mesh): a mesh that
    # is none raises
    with pytest.raises(tmx.MXNetError, match="a serving mesh is a dict"):
        tgen.LlamaServingEngine(tnet, max_len=64, mesh=object())


def test_unported_serving_surface_raises_naming_the_roadmap(nets):
    (_, tnet), _ = nets
    # the observability keywords are ported in slice 20, with the
    # reference's defaults (tests/test_torch_serving_metrics.py serves
    # through them)
    from mxnet_tpu.serving import ServerConfig as JConfig

    jc, tc = JConfig(), tserving.ServerConfig()
    for kw in ("summary_every", "http_port", "http_host", "slo",
               "slo_window"):
        assert getattr(tc, kw) == getattr(jc, kw), kw
    cfg = tserving.ServerConfig(http_port=0, slo={"ttft_ms": 1},
                                summary_every=4, http_host="127.0.0.1",
                                slo_window=8)
    assert (cfg.http_port, cfg.slo, cfg.summary_every, cfg.slo_window) == \
        (0, {"ttft_ms": 1}, 4, 8)
    # GenerativeServer(mesh=) is ported in slice 12
    # (test_torch_serving_mesh): a mesh that is none raises
    with pytest.raises(tmx.MXNetError, match="a serving mesh is a dict"):
        tserving.GenerativeServer(tnet, mesh=object())
    # calib_data is ported in slice 14 (quantize_net)
    assert tserving.ServerConfig(calib_data=[1]).calib_data == [1]
    with pytest.raises(tmx.MXNetError, match="kv_mode='paged'"):
        tserving.GenerativeServer(tnet, _config(tserving, kv_mode="slots",
                                                radix_cache=True))
    srv = tserving.GenerativeServer(tnet, _config(tserving))
    with pytest.raises(tserving.ServerClosedError):
        srv.submit(PROMPTS[0], max_new_tokens=2)
    with pytest.raises(tmx.MXNetError, match="max_len"):
        srv.submit(np.ones(60, np.int32), max_new_tokens=8)

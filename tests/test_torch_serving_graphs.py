"""The serving engine's programs as graphs, on the CPU against the JAX
package.

On a card every program of ``LlamaServingEngine`` (prefill, suffix
prefill, gather, scatter, verify, and the decode tick in every mode) is
a CUDA graph keyed by its shape, as the reference compiles one program a
shape.  Here, without a card, two things are held:

* the ``compiled_signatures`` key set of each mode (paged, slots, radix,
  speculative) equals the reference's for the same requests, except the
  decode step's key, which names the port's CUDA graph (its kv mode,
  slots, table width and dtype);
* the graph plumbing (``_program``: inputs and outputs as views of the
  engine's two arenas, outputs overwritten by the next replay and copied
  out, a graph a key) gives the eager
  engine's tokens: a stand-in ``cuda_graph.capture`` records the
  program and replays it by running it again on its static inputs and
  writing the results into the same output tensors, as a replayed graph
  does.  The greedy tokens then equal the reference server's and the
  reference's offline ``generate``, token for token, in the paged,
  slots, radix, speculative and int8 modes, with every program captured
  once a key and replayed;
* ``ServerConfig(capture_buckets=True)`` captures the bucket table's
  programs (prefill and scatter; gather and the suffix prefill with the
  radix cache; verify with a draft) when the server is built,
  serving then captures nothing, and the arenas stay within twice the
  largest program's inputs and outputs.
"""
import contextlib

import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving

from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.serving import generative as tgen

from test_torch_serving import (NEW, PROMPTS, WAIT,  # noqa: E402
                                _config, _modes, _serve, nets,
                                oracle)  # noqa: F401

MODES = ["paged", "slots", "radix", "spec_same_net", "spec_rejecting",
         "int8"]


def _kw(nets, mode):
    if mode == "paged":
        return {}, {}
    if mode == "int8":
        return {"int8": True}, {"int8": True}
    return _modes(nets)[mode]


class _StandIn:
    """A captured program: ``replay`` runs it again on the static inputs
    and writes the results into the tensors of the first run, which the
    caller must copy out before the next replay."""

    def __init__(self, fn):
        self.fn = fn
        self.outputs = fn()
        self.pool_bytes = 0
        self.replays = 0

    def replay(self):
        tgen._tree_copy(self.outputs, self.fn())
        self.replays += 1


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Every engine built in the test takes the graph path on the CPU."""
    made = []
    init = tgen.LlamaServingEngine.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        self._graphs = {}
        made.append(self)

    monkeypatch.setattr(tgen.LlamaServingEngine, "__init__", patched)
    monkeypatch.setattr(tgen.cuda_graph, "warmup", lambda fn: fn())
    monkeypatch.setattr(tgen.cuda_graph, "capture",
                        lambda fn, **kw: _StandIn(fn))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return made


def _first(mode):
    return 4 if mode == "radix" else None


def _serve_in_turn(pkg, net, **kw):
    """Serve PROMPTS one at a time (each answered before the next is
    sent): the batches, and so the program shapes, do not depend on when
    the lanes wake."""
    srv = pkg.GenerativeServer(net, _config(pkg, **kw))
    with srv:
        for p in PROMPTS:
            srv.submit(p, max_new_tokens=NEW).result(WAIT)
        stats = srv.stats()
    return stats, srv


@pytest.mark.parametrize("mode", ["paged", "slots", "radix",
                                  "spec_same_net"])
def test_compiled_signature_keys_match_the_reference(nets, mode):
    (jnet, tnet), _ = nets
    jkw, tkw = _kw(nets, mode)
    jstats, _ = _serve_in_turn(jserving, jnet, **jkw)
    tstats, srv = _serve_in_turn(tserving, tnet, **tkw)
    jsigs = {tuple(s) for s in jstats["compiled_signatures"]}
    tsigs = {tuple(s) for s in tstats["compiled_signatures"]}
    assert {s for s in tsigs if s[0] != "step"} == \
        {s for s in jsigs if s[0] != "step"}
    assert any(s[0] == "step" for s in tsigs) == \
        any(s[0] == "step" for s in jsigs)
    assert srv.engine.graph_pool_bytes() == {}  # no graph on the CPU


@pytest.mark.parametrize("mode", MODES)
def test_graphed_programs_give_the_eager_tokens(nets, oracle, mode,
                                                stand_in_graphs):
    (jnet, tnet), _ = nets
    jkw, tkw = _kw(nets, mode)
    first = _first(mode)
    touts, tstats, srv = _serve(tserving, tnet, PROMPTS, first, **tkw)
    jouts, _, _ = _serve(jserving, jnet, PROMPTS, first, **jkw)
    for t, j, o in zip(touts, jouts, oracle):
        np.testing.assert_array_equal(t, j)
        if mode != "int8":
            np.testing.assert_array_equal(t, o)
    eng = srv.engine
    assert eng in stand_in_graphs
    kinds = {k[0] for k in eng._graphs}
    want = {"prefill"}
    if mode != "slots":
        want |= {"scatter"}
    if mode == "radix":
        want |= {"gather", "prefill_sfx"}
    if mode.startswith("spec"):
        want |= {"verify"}
    assert want <= kinds, kinds
    for key, entry in eng._graphs.items():
        assert entry != "eager", key
        assert entry[1].replays >= 1, key
    # one graph a key: the prefill buckets the signatures name
    sigs = {tuple(s) for s in tstats["compiled_signatures"]}
    assert {k for k in eng._graphs if k[0] == "prefill"} == \
        {s for s in sigs if s[0] == "prefill"}


def test_prefilled_rows_survive_the_next_replay(nets, stand_in_graphs):
    """Two prefills of one bucket before either commits (the prefill
    lane runs ahead of the handoff): the first call's rows and token are
    its own, not the second replay's."""
    (_, tnet), _ = nets
    eager = tgen.LlamaServingEngine(tnet, max_len=64, num_slots=2,
                                    kv_mode="paged", block_size=8)
    eager._graphs = None
    graphed = tgen.LlamaServingEngine(tnet, max_len=64, num_slots=2,
                                      kv_mode="paged", block_size=8)
    rs = np.random.RandomState(5)
    batches = [rs.randint(1, 250, size=(2, 16)).astype(np.int32)
               for _ in range(2)]
    t0s = np.array([16, 11], np.int32)
    want = [eager.prefill_rows(b, t0s) for b in batches]
    got = [graphed.prefill_rows(b, t0s) for b in batches]
    assert len(graphed._graphs) == 1
    for (wt, wr), (gt, gr) in zip(want, got):
        np.testing.assert_array_equal(gt.numpy(), wt.numpy())
        for (wk, wv), (gk, gv) in zip(wr, gr):
            np.testing.assert_array_equal(gk.numpy(), wk.numpy())
            np.testing.assert_array_equal(gv.numpy(), wv.numpy())


def _leaf_bytes(tree):
    leaves = []
    tgen._tree(leaves.append, tree)
    return sum(-(-t.numel() * t.element_size() // 256) * 256
               for t in leaves)


@pytest.mark.parametrize("mode", ["paged", "slots", "radix",
                                  "spec_same_net"])
def test_bucket_table_is_captured_when_the_server_is_built(
        nets, oracle, mode, stand_in_graphs):
    (_, tnet), _ = nets
    _, tkw = _kw(nets, mode)
    cfg = _config(tserving, capture_buckets=True, **tkw)
    srv = tserving.GenerativeServer(tnet, cfg)
    engines = [e for e in stand_in_graphs if e._graphs]
    table = {("prefill", kb, lb) for kb, lb in cfg.policy.signatures()}
    for eng in engines:
        want = set(table)
        if eng.kv_mode == "paged":
            want |= {("scatter", kb, lb) for _, kb, lb in table}
        if mode == "radix":
            want |= {("gather", kb, lp) for _, kb, lp in table}
            want |= {("prefill_sfx", kb, lp, lb) for _, kb, lp in table
                     for _, kb2, lb in table if kb2 == kb}
        if eng.spec_k:
            want.add(("verify",))
        assert set(eng._graphs) == want
    assert len(engines) == (2 if mode.startswith("spec") else 1)
    before = [dict(e._graphs) for e in engines]
    with srv:
        outs = [f.result(WAIT) for f in
                [srv.submit(p, max_new_tokens=NEW) for p in PROMPTS]]
    for t, o in zip(outs, oracle):
        np.testing.assert_array_equal(t, o)
    for eng, was in zip(engines, before):
        assert eng._graphs == was  # serving captured nothing more
        for side, pos in (("in", 0), ("out", 2)):
            need = max(_leaf_bytes(e[pos]) for e in eng._graphs.values())
            assert need <= eng._arenas[side].numel() <= 2 * need
        assert eng._arena_bytes <= 2 * (eng._arenas["in"].numel() +
                                        eng._arenas["out"].numel())
        assert eng.graph_pool_bytes()[("arena",)] == eng._arena_bytes


def test_past_the_budget_programs_run_eagerly(nets, oracle,
                                              stand_in_graphs,
                                              monkeypatch):
    """Once the engine's graphs hold its budget, a new program shape
    runs eagerly, counted, with the eager tokens."""
    from mxnet_tpu_torch import telemetry

    (_, tnet), _ = nets
    monkeypatch.setattr(tgen.cuda_graph, "budget", lambda device: 1)
    telemetry.enable()
    try:
        telemetry.reset()
        outs, _, srv = _serve(tserving, tnet, PROMPTS)
        over = telemetry.counters().get("serving.graph_over_budget", 0)
    finally:
        telemetry.disable()
    for t, o in zip(outs, oracle):
        np.testing.assert_array_equal(t, o)
    graphed = [k for k, e in srv.engine._graphs.items() if e != "eager"]
    assert len(graphed) == 1  # the first capture, before the budget held
    assert over == len(srv.engine._graphs) - 1 > 0

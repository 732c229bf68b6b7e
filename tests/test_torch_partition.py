"""The partition-rule engine of the port against the JAX package's, and a
dp2×tp2 MLP step on four ranks against the reference's single-device
oracle.

The rule engine is pure Python in both packages, so its cases (those of
the reference's ``tests/test_partition.py``) run both on the same
``(name, shape)`` lists here, the reference against a mesh on its 8
virtual devices, the port against the same axes given as a dict.  The
step spawns one gloo group of four ranks (``mxnet_tpu_torch.launch.run``)
that trains the reference's MLP for four steps through a stock
``Trainer(partition_rules=..., mesh={'dp': 2, 'tp': 2})`` from the
reference's weights.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import spawn  # noqa: E402

HIDDEN, OUT, BATCH, STEPS = 32, 8, 16, 4
XS = np.random.RandomState(0).randn(BATCH, HIDDEN).astype("float32")
YS = np.random.RandomState(1).randn(BATCH, OUT).astype("float32")


def _pair():
    from mxnet_tpu.parallel import partition as jpt
    from mxnet_tpu_torch.parallel import partition as tpt

    return jpt, tpt


def _meshes(axes):
    from mxnet_tpu import parallel as jpar

    return jpar.make_mesh(dict(axes)), dict(axes)


def _cov(c):
    return (dict(c.matched), list(c.replicated), list(c.unmatched),
            list(c.rank_skips), list(c.dropped), list(c.unused),
            dict(c.mesh_shape), c.summary())


def _both(build, call):
    """``call(pt, rules)`` on each package's rules from ``build(pt)``;
    each result (or the MXNetError message) must be the same."""
    outs = []
    for pt in _pair():
        try:
            outs.append(call(pt, build(pt)))
        except Exception as e:  # both packages must raise alike
            assert type(e).__name__ == "MXNetError", e
            outs.append(("raised", str(e)))
    assert outs[0] == outs[1]
    return outs[0]


def test_first_match_wins_and_scalars_replicate():
    table = ((r"weight$", ("tp", None)), (r"0_weight$", (None, "tp")),
             (r".*", ()))
    got = _both(lambda pt: pt.PartitionRules(table),
                lambda pt, r: (r.match("dense0_weight", (8, 4)),
                               r.match("scale", ()), r.match("bias", (8,))))
    assert got == ((r"weight$", ("tp", None)), (None, ()), (r".*", ()))


def test_unmatched_without_catch_all():
    jm, tm = _meshes({"dp": 4, "tp": 2})
    shapes = {"weight": (8, 4), "running_mean": (8,)}
    covs = [_cov(pt.PartitionRules(((r"weight$", ("tp", None)),))
                 .coverage(shapes, m)) for pt, m in zip(_pair(), (jm, tm))]
    assert covs[0] == covs[1] and covs[1][2] == ["running_mean"]
    for pt, m in zip(_pair(), (jm, tm)):
        rules = pt.PartitionRules(((r"weight$", ("tp", None)),),
                                  on_unmatched="error")
        with pytest.raises(Exception, match="running_mean"):
            rules.specs({"running_mean": (8,)}, m)


@pytest.mark.parametrize("table,kw,match", [
    (((r"(q|k", ("tp", None)),), {}, "invalid partition-rule regex"),
    ((), {}, "empty"),
    (((r".*", ()),), {"on_unmatched": "warn"}, "on_unmatched"),
])
def test_invalid_regex_and_empty_table_raise(table, kw, match):
    for pt in _pair():
        with pytest.raises(Exception, match=match) as e:
            pt.PartitionRules(table, **kw)
        assert type(e.value).__name__ == "MXNetError"
    for pt in _pair():
        with pytest.raises(Exception, match="unknown model family"):
            pt.PartitionRules.for_family("gpt17")


def test_rank_guard_routes_flat_moe_names():
    jm, tm = _meshes({"dp": 2, "ep": 2, "tp": 2})
    shapes = {"moe_gate_weight": (4, 16, 8), "mlp_gate_weight": (16, 8),
              "router_weight": (4, 8), "ln_in_weight": (8,)}
    res = []
    for pt, m in zip(_pair(), (jm, tm)):
        cov = pt.Coverage()
        specs = pt.PartitionRules.for_family("mixtral").specs(
            shapes, m, coverage=cov)
        res.append((specs, _cov(cov)))
    assert res[0] == res[1]
    specs = res[1][0]
    assert specs["moe_gate_weight"] == ("ep", "tp", None)
    assert specs["mlp_gate_weight"] == ("tp", None)
    assert "router_weight" not in specs and "ln_in_weight" not in specs


def test_structural_and_flat_names_take_the_same_layout():
    jm, tm = _meshes({"dp": 4, "tp": 2})
    pairs = [("model.layers.0.self_attn.q_proj.weight",
              "model_layers_0_attn_q_weight", (8, 8)),
             ("model.layers.0.mlp.down_proj.weight",
              "model_layers_0_mlp_down_weight", (8, 16)),
             ("model.embed_tokens.weight", "model_embed_weight", (32, 8))]
    for dotted, flat, shape in pairs:
        res = [pt.PartitionRules.for_family("llama").specs(
            {dotted: shape, flat: shape}, m)
            for pt, m in zip(_pair(), (jm, tm))]
        assert res[0] == res[1]
        assert res[1][dotted] == res[1][flat]


@pytest.mark.parametrize("axes,shape,why", [
    ({"dp": 8}, (8, 8), "absent"),
    ({"dp": 4, "tp": 2}, (7, 8), "indivisible"),
    ({"dp": 8, "tp": 1}, (8, 8), "size1"),
])
def test_resolve_drops_absent_size1_indivisible(axes, shape, why):
    jm, tm = _meshes(axes)
    res = []
    for pt, m in zip(_pair(), (jm, tm)):
        cov = pt.Coverage()
        specs = pt.PartitionRules.for_family("llama").specs(
            {"q_weight": shape}, m, coverage=cov)
        res.append((specs, list(cov.dropped)))
    assert res[0] == res[1]
    assert res[1][0] == {} and ("q_weight", "tp", why) in res[1][1]


def test_coverage_reports_unused_rules_and_summary():
    jm, tm = _meshes({"dp": 4, "tp": 2})
    shapes = {"q_weight": (8, 8), "norm_weight": (8,)}
    covs = [pt.PartitionRules.for_family("llama").coverage(shapes, m)
            for pt, m in zip(_pair(), (jm, tm))]
    assert _cov(covs[0]) == _cov(covs[1])
    assert covs[0].render() == covs[1].render()
    assert covs[1].summary() == {"mesh_shape": {"dp": 4, "tp": 2},
                                 "sharded_params": 1,
                                 "replicated_params": 1}


def test_stacked_spec_and_as_rules():
    for pt in _pair():
        assert pt.stacked_spec(("tp", None)) == (None, "tp", None)
        assert pt.stacked_spec((), stack_axes=2) == (None, None)
        assert pt.as_rules(None) is None
        r = pt.PartitionRules(((r".*", ()),))
        assert pt.as_rules(r) is r
        assert pt.as_rules("llama").rules[0][0] == pt.LLAMA_RULES[0][0]
        assert pt.as_rules([(r".*", ())]).rules[0][2] == ()
    jpt, tpt = _pair()
    for name in ("LLAMA_RULES", "MIXTRAL_RULES", "SERVING_RULES"):
        assert getattr(jpt, name) == getattr(tpt, name)
    assert jpt.FAMILY_RULES == tpt.FAMILY_RULES


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 2}, {"dp": 4},
                                  {"dp": 2, "ep": 2, "tp": 2}])
def test_llama_param_pspecs_match_the_reference(axes):
    from mxnet_tpu.models import llama as jllama
    from mxnet_tpu_torch.models import llama as tllama

    jm, tm = _meshes(axes)
    for kw in ({}, {"tie_embeddings": True}):
        want = jllama.llama_param_pspecs(jllama.llama_tiny(**kw), jm)
        got = tllama.llama_param_pspecs(tllama.llama_tiny(**kw), tm)
        assert got == want


# --------------------------------------------------------------------------
# dp2×tp2 step against the single-device oracle
# --------------------------------------------------------------------------

def _worker(tmp):
    import pathlib

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd, gluon, nd, parallel
    from mxnet_tpu_torch.convert import load_numpy_params

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    w = dict(np.load(tmp / "weights.npz"))
    cpu = tmx.cpu()
    parallel.initialize(ctx=cpu)

    def mlp():
        nn = gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Dense(HIDDEN, activation="relu", in_units=HIDDEN),
                nn.Dense(OUT, in_units=HIDDEN))
        load_numpy_params(net, w, ctx=cpu)
        return net

    out = {}
    mesh = parallel.make_mesh({"dp": 2, "tp": 2})
    net = mlp()
    ws = [p.name for p in net.collect_params().values()
          if p.name.endswith("weight")]
    rules = [(rf"^{ws[0]}$", ("tp", None)), (rf"^{ws[1]}$", (None, "tp")),
             (r".*", ())]
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       partition_rules=rules, mesh=mesh)
    out["sharded_params"] = tr.placement.summary()["sharded_params"]
    p0 = next(iter(net.collect_params().values()))
    before = p0.data()._data.placements
    p0.set_data(w[next(iter(w))] * 2)  # the same values, doubled
    out["set_data"] = p0.data().asnumpy()
    out["set_data_kept"] = before == p0.data()._data.placements
    p0.set_data(w[next(iter(w))])
    out["placements"] = str([p.data()._data.placements
                             for p in net.collect_params().values()])
    loss_fn = gluon.loss.L2Loss()
    x = parallel.shard_batch(nd.array(XS, ctx=cpu), mesh)
    y = parallel.shard_batch(nd.array(YS, ctx=cpu), mesh)
    losses = []
    for _ in range(STEPS):
        with autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        tr.step(BATCH)
        losses.append(float(loss.asscalar()))
    out["losses"] = np.array(losses)
    for k, p in net._collect_params_with_prefix().items():
        out["param." + k] = p.data().asnumpy()
    parallel.set_mesh(None)
    # mesh= alone: pure data parallelism
    tr = gluon.Trainer(mlp().collect_params(), "sgd",
                       {"learning_rate": 0.1}, mesh=mesh)
    out["dp_only"] = str(tr.placement.summary())
    parallel.set_mesh(None)
    np.savez(tmp / f"rank{parallel.rank()}.npz", **out)


@pytest.fixture(scope="module")
def oracle():
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag, gluon as jg, nd as jnd
    from mxnet_tpu import parallel as jpar

    jpar.set_mesh(None)
    net = jg.nn.HybridSequential()
    with net.name_scope():
        net.add(jg.nn.Dense(HIDDEN, activation="relu"), jg.nn.Dense(OUT))
    net.initialize(jmx.init.Xavier())
    net(jnd.ones((1, HIDDEN)))
    weights = {k: p.data().asnumpy()
               for k, p in net._collect_params_with_prefix().items()}
    tr = jg.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    loss_fn = jg.loss.L2Loss()
    losses = []
    for _ in range(STEPS):
        with jag.record():
            loss = loss_fn(net(jnd.array(XS)), jnd.array(YS)).mean()
        loss.backward()
        tr.step(BATCH)
        losses.append(float(loss.asscalar()))
    return {"weights": weights, "losses": np.array(losses),
            "params": {k: p.data().asnumpy() for k, p in
                       net._collect_params_with_prefix().items()}}


@pytest.fixture(scope="module")
def ranks(oracle, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition")
    np.savez(tmp / "weights.npz", **oracle["weights"])
    return spawn(4, tmp, __file__)


def test_dp_tp_step_matches_single_device_oracle(ranks, oracle):
    for out in ranks:
        assert int(out["sharded_params"]) == 2
        assert "Shard(dim=0)" in str(out["placements"])
        np.testing.assert_allclose(out["losses"], oracle["losses"],
                                   rtol=1e-5, atol=1e-6)
        for k, v in oracle["params"].items():
            np.testing.assert_allclose(out["param." + k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_set_data_respects_existing_sharding(ranks, oracle):
    first = next(iter(oracle["weights"].values()))
    for out in ranks:
        assert bool(out["set_data_kept"])
        np.testing.assert_array_equal(out["set_data"], first * 2)


def test_trainer_mesh_only_means_pure_dp(ranks):
    for out in ranks:
        assert str(out["dp_only"]) == str(
            {"mesh_shape": {"dp": 2, "tp": 2}, "sharded_params": 0,
             "replicated_params": 4})


def test_trainer_partition_rules_without_mesh_raises():
    import mxnet_tpu_torch as tmx

    tmx.parallel.set_mesh(None)
    net = tmx.gluon.nn.Dense(4, in_units=4)
    net.initialize(ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="mesh"):
        tmx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1},
                          partition_rules=[(r".*", ())])


if __name__ == "__main__":
    _worker(sys.argv[1])

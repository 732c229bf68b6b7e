"""The tools of the PyTorch/CUDA port (``util``, ``runtime``,
``test_utils``, ``monitor``, ``visualization``) against the JAX package,
on the CPU.

``util``'s flags and scopes behave as the reference's (thread-local);
``runtime.Features()`` reports what torch provides (no card here: CUDA
false; TPU, XLA and PALLAS false everywhere); ``test_utils``' helpers
give the reference's results on the same numbers; ``Monitor`` on an
eager net collects the reference's rows, with the same stats within
1e-6 (the same weights), keeps a fused 1×1 conv + BatchNorm + ReLU run
fused while it reports each of its blocks, and refuses a hybridized net
(ROADMAP item 9); ``visualization`` prints and returns the reference's
text for the same symbol, character for character.
"""
import threading

import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_numpy_params
from mxnet_tpu_torch.ops import conv_bn_relu as cbr

CPU = tmx.cpu()


# --- util --------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [jmx, tmx], ids=["reference", "port"])
def test_util_np_flags(pkg):
    util = pkg.util
    assert not util.is_np_shape()
    prev = util.set_np_shape(True)
    assert prev is False and util.is_np_shape()
    util.reset_np()
    assert not util.is_np_shape() and not util.is_np_array()

    @util.use_np
    def inner():
        return util.is_np_shape(), util.is_np_array()

    assert inner() == (True, True)
    assert not util.is_np_shape()
    with util.np_shape(True):
        assert util.is_np_shape()
    assert not util.is_np_shape()
    with util.np_array(True):
        assert util.is_np_array()

    @util.np_array(True)
    def arr():
        return util.is_np_array()

    assert arr() and not util.is_np_array()
    with pytest.raises(pkg.MXNetError):
        util.set_np(shape=False, array=True)
    util.reset_np()


def test_util_flags_are_thread_local_and_env_helpers(tmp_path):
    tmx.util.set_np()
    seen = []
    t = threading.Thread(target=lambda: seen.append(
        tmx.util.is_np_array()))
    t.start()
    t.join()
    tmx.util.reset_np()
    assert seen == [False]
    tmx.util.setenv("MXT_UTIL_TEST", 3)
    assert tmx.util.getenv("MXT_UTIL_TEST") == "3"
    tmx.util.makedirs(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    assert tmx.util.get_gpu_count() == 0
    with pytest.raises(tmx.MXNetError):
        tmx.util.get_gpu_memory(0)


# --- runtime -------------------------------------------------------------

def test_runtime_features():
    feats = tmx.runtime.Features()
    assert feats is tmx.runtime.Features()
    assert not feats.is_enabled("CUDA") and not feats.is_enabled("cudnn")
    for off in ("TPU", "XLA", "PALLAS", "NCCL"):
        assert not feats.is_enabled(off)
    assert feats.is_enabled("CPU") and feats.is_enabled("NATIVE_ENGINE")
    with pytest.raises(RuntimeError):
        feats.is_enabled("NOT_A_FEATURE")
    names = [f.name for f in tmx.runtime.feature_list()]
    ref = [f.name for f in jmx.runtime.feature_list()]
    assert set(ref) <= set(names)
    assert repr(tmx.runtime.Feature("CUDA", False)) == \
        repr(jmx.runtime.Feature("CUDA", False))


# --- test_utils ----------------------------------------------------------

def test_assert_almost_equal_and_max_rel_err_match_the_reference():
    a = onp.array([1.0, 2.0, onp.nan, 0.0])
    b = onp.array([1.0 + 1e-8, 2.0, onp.nan, 0.0])
    for pkg in (jmx, tmx):
        pkg.test_utils.assert_almost_equal(a, b)
        with pytest.raises(AssertionError):
            pkg.test_utils.assert_almost_equal(a, b + 1.0)
    for x, y in ((a, b), (a, a[::-1]), ([], []), ([1.0], [onp.nan])):
        assert tmx.test_utils.max_rel_err(x, y, 1e-3) == \
            jmx.test_utils.max_rel_err(x, y, 1e-3)


def test_check_numeric_gradient_and_consistency():
    def fn(x, y):
        return x * tmx.nd.sin(y) + x * x

    tmx.test_utils.check_numeric_gradient(
        fn, [onp.array([[0.5, -1.0]]), onp.array([[1.5, 0.3]])], ctx=CPU)
    with pytest.raises(AssertionError):
        tmx.test_utils.check_numeric_gradient(
            lambda x: tmx.nd.BlockGrad(x) * x, [onp.array([1.0, 2.0])],
            ctx=CPU)
    worst = []
    x = onp.array([[1.0, -2.0]], onp.float32)
    ref = tmx.test_utils.check_consistency(
        lambda a: tmx.nd.tanh(a) * 2, [x], [CPU, CPU], collect=worst.append)
    onp.testing.assert_allclose(ref, onp.tanh(x) * 2, rtol=1e-6)
    assert worst == [0.0]
    assert tmx.test_utils.default_context() == CPU
    with tmx.cpu(0):
        assert tmx.test_utils.default_context() == CPU
    assert tmx.test_utils.rand_ndarray((2, 3), ctx=CPU).shape == (2, 3)
    assert len(tmx.test_utils.rand_shape_3d()) == 3


def test_with_seed_seeds_numpy_and_the_generators():
    draws = []

    @tmx.test_utils.with_seed(42)
    def body():
        draws.append((onp.random.rand(),
                      tmx.random.uniform(shape=(2,), ctx=CPU).asnumpy()))

    body()
    body()
    assert draws[0][0] == draws[1][0]
    onp.testing.assert_array_equal(draws[0][1], draws[1][1])


# --- monitor -------------------------------------------------------------

def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
    return net


def test_monitor_gluon_matches_the_reference():
    jnet, tnet = _mlp(jmx), _mlp(tmx)
    jnet.initialize(jmx.init.Xavier())
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    load_numpy_params(tnet, arrays, ctx=CPU)
    rows = {}
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        mon = pkg.monitor.Monitor(interval=1, pattern=".*dense.*",
                                  sort=True)
        mon.install(net)
        mon.tic()
        net(pkg.nd.ones((2, 3), **({"ctx": CPU} if pkg is tmx else {})))
        rows[pkg] = mon.toc()
        assert len(rows[pkg]) == 2 and all(r[0] == 1 for r in rows[pkg])
        mon.uninstall()
        mon.tic()
        net(pkg.nd.ones((2, 3), **({"ctx": CPU} if pkg is tmx else {})))
        assert mon.toc() == []
    assert [r[:2] for r in rows[tmx]] == [r[:2] for r in rows[jmx]]
    for g, r in zip(rows[tmx], rows[jmx]):
        assert float(g[2]) == pytest.approx(float(r[2]), rel=1e-6)


def test_monitor_interval_monitor_all_and_print(capsys):
    net = _mlp(tmx)
    net.initialize(ctx=CPU)
    mon = tmx.monitor.Monitor(interval=2,
                              stat_func=lambda x: x.abs().sum())
    mon.install(net, monitor_all=True)
    got = []
    for _ in range(3):
        mon.tic()
        net(tmx.nd.ones((2, 3), ctx=CPU))
        got.append(mon.toc())
    assert [len(g) for g in got] == [4, 0, 4]
    assert {r[1] for r in got[0]} == {"mlp_dense0_output",
                                      "mlp_dense0_input0",
                                      "mlp_dense1_output",
                                      "mlp_dense1_input0"}
    mon = tmx.monitor.Monitor(1)
    mon.install(net)
    mon.tic()
    net(tmx.nd.ones((2, 3), ctx=CPU))
    mon.toc_print()
    assert capsys.readouterr().out.count("Batch:") == 2


def test_monitor_on_a_hybridized_net_is_left_out():
    net = _mlp(tmx)
    net.initialize(ctx=CPU)
    net.hybridize()
    with pytest.raises(tmx.MXNetError, match="item 9"):
        tmx.monitor.Monitor(1).install(net)


def _fusable(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="f_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 1, in_channels=4), nn.BatchNorm(in_channels=8),
                nn.Activation("relu"))
    return net


def test_monitor_keeps_the_fused_run_fused_and_sees_each_block():
    """Trap 6 on the CPU: the fused op still runs (its plain version
    here, the kernel on the card) and the monitor reports the conv's, the
    BatchNorm's and the ReLU's outputs with the reference's stats."""
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 4, 5, 5).astype(onp.float32)
    jnet, tnet = _fusable(jmx), _fusable(tmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()}
    arrays["1.running_mean"] = rng.randn(8).astype(onp.float32) * 0.1
    arrays["1.running_var"] = rng.rand(8).astype(onp.float32) + 0.5
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    load_numpy_params(tnet, arrays, ctx=CPU)
    plain = tnet(tmx.nd.array(x, ctx=CPU)).asnumpy()
    rows = {}
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        mon = pkg.monitor.Monitor(1, sort=True)
        mon.install(net)
        calls = cbr.conv1x1_bn_relu.calls
        mon.tic()
        out = net(pkg.nd.array(x, **({"ctx": CPU} if pkg is tmx else {})))
        rows[pkg] = mon.toc()
        mon.uninstall()
        if pkg is tmx:
            assert cbr.conv1x1_bn_relu.calls == calls + 1
            onp.testing.assert_array_equal(out.asnumpy(), plain)
    names = [r[1] for r in rows[tmx]]
    assert names == [r[1] for r in rows[jmx]] and len(names) == 3
    for g, r in zip(rows[tmx], rows[jmx]):
        assert float(g[2]) == pytest.approx(float(r[2]), rel=1e-5)


# --- visualization ---------------------------------------------------------

def _graph(pkg):
    sym = pkg.sym
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def test_print_summary_text_equals_the_reference(capsys):
    out = {}
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            net = _graph(pkg)
        total = pkg.visualization.print_summary(net, shape={"data": (1, 4)})
        out[pkg] = (total, capsys.readouterr().out)
    assert out[tmx] == out[jmx]
    assert out[tmx][0] == (4 * 8 + 8) + (8 * 2 + 2)
    assert "fc1 (FullyConnected)" in out[tmx][1]


@pytest.mark.parametrize("hide", [True, False])
def test_plot_network_text_equals_the_reference(hide):
    dots = []
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            net = _graph(pkg)
        dots.append(pkg.viz.plot_network(net, title="net",
                                         hide_weights=hide))
    assert dots[1] == dots[0]
    assert dots[1].startswith("digraph") and '"data" -> "fc1"' in dots[1]
    assert ("fc1_weight" in dots[1]) is not hide

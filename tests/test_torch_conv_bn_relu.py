"""The fused 1×1 conv + BatchNorm + ReLU of the PyTorch/CUDA port against
the JAX side.

The kernel's plain PyTorch version (what a CPU tensor takes) is held
against the Pallas kernel it replaces, ``fused_matmul_affine_relu`` of
``tools/pallas_conv_probe.py``, run in interpret mode; ``conv1x1_bn_relu``
(the fold of an inference BatchNorm into the product) against the JAX
package's ``Convolution → BatchNorm(use_global_stats) → relu``; and the
``HybridSequential`` fusion is pinned to the runs and modes where the fold
is exact.
"""
import contextlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import conv_bn_relu as cbr

CPU = tmx.cpu()
PROBE = Path(__file__).resolve().parents[1] / "tools" / "pallas_conv_probe.py"


@pytest.fixture(scope="module")
def probe():
    """``tools/pallas_conv_probe.py`` loaded by path, unedited."""
    spec = importlib.util.spec_from_file_location("_pallas_conv_probe",
                                                  PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (m, k)).astype(np.float32),
            (rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32),
            rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.uniform(-0.5, 0.5, n).astype(np.float32))


# bf16 x and w on both sides (the same rounding of the same f32 draws).
# Both sum the exact bf16 products in f32, in other orders, and round the
# result to bf16 once: one bf16 ulp of each reference value, at most
# 2^-7·|r| (+1e-6 for values near zero).
@pytest.mark.parametrize("m,k,n,blocks", [
    (256, 128, 64, dict(block_m=256, block_n=64, block_k=64)),
    (1024, 512, 256, {}),
])
def test_plain_matches_pallas_interpret_bf16(probe, m, k, n, blocks):
    x, w, scale, bias = _operands(m + k + n, m, k, n)
    ref = probe.fused_matmul_affine_relu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), interpret=True, **blocks)
    ref = np.asarray(ref.astype(jnp.float32))
    got = cbr.fused_matmul_affine_relu(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    assert (ref == 0).mean() > 0.2  # the ReLU clamps part of the output
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("m,k,n", [(49, 100, 30), (1, 64, 64)])
def test_plain_at_ragged_shapes_matches_numpy(m, k, n):
    """f32 against a float64 numpy reference: 1e-5 (f32 sums over
    K ≤ 100 of values below 1)."""
    x, w, scale, bias = _operands(m * n, m, k, n)
    ref = np.maximum(x.astype(np.float64) @ w * scale + bias, 0.0)
    got = cbr.fused_matmul_affine_relu(*map(torch.from_numpy,
                                            (x, w, scale, bias)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.abs(got.numpy() - ref).max() <= 1e-5


def _conv_bn(seed, b, c, h, n, with_bias):
    rng = np.random.RandomState(seed)
    arrs = dict(
        x=rng.normal(size=(b, c, h, h)).astype(np.float32),
        weight=(rng.normal(size=(n, c, 1, 1)) / np.sqrt(c)).astype(
            np.float32),
        gamma=rng.uniform(0.5, 1.5, n).astype(np.float32),
        beta=rng.normal(0, 0.3, n).astype(np.float32),
        mean=rng.normal(0, 0.3, n).astype(np.float32),
        var=rng.uniform(0.3, 2.0, n).astype(np.float32))
    arrs["bias"] = rng.normal(0, 0.5, n).astype(np.float32) \
        if with_bias else None
    return arrs


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_bn_relu_matches_jax_chain(stride, with_bias, fix_gamma):
    """f32 on both sides, with a conv bias (``BottleneckV1.body[0]`` has
    one; the probe's fold has none), gamma fixed at 1 or not, nontrivial
    moving statistics: within 1e-5 of the reference's largest value."""
    a = _conv_bn(stride * 4 + with_bias * 2 + fix_gamma, 2, 24, 7, 40,
                 with_bias)
    y = jnd.Convolution(
        jnd.array(a["x"]), jnd.array(a["weight"]),
        None if a["bias"] is None else jnd.array(a["bias"]), kernel=(1, 1),
        stride=(stride, stride), num_filter=40, no_bias=a["bias"] is None)
    y = jnd.BatchNorm(y, jnd.array(a["gamma"]), jnd.array(a["beta"]),
                      jnd.array(a["mean"]), jnd.array(a["var"]), eps=1e-5,
                      fix_gamma=fix_gamma, use_global_stats=True)[0]
    ref = jnd.relu(y).asnumpy()
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    got = cbr.conv1x1_bn_relu(t["x"], t["weight"], t["bias"], t["gamma"],
                              t["beta"], t["mean"], t["var"], 1e-5,
                              (stride, stride), fix_gamma)
    assert got.shape == ref.shape == (2, 40, 4 if stride == 2 else 7,
                                      4 if stride == 2 else 7)
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _narrow_resnet():
    return tresnet.ResNetV1(tresnet.BottleneckV1, [1, 1, 1, 1],
                            [8, 32, 64, 128, 256], classes=10)


def test_fusion_fires_only_in_unrecorded_inference():
    """4 fused calls a forward in the narrow net (one per bottleneck);
    none under ``autograd.record()`` or ``train_mode()`` (BatchNorm then
    normalizes by the batch), 4 again in ``train_mode()`` once every
    BatchNorm uses its global statistics; and the fused output equals the
    layers' own."""
    tmx.random.seed(3)
    net = _narrow_resnet()
    net.initialize(ctx=CPU)
    x = tmx.nd.array(np.random.RandomState(0).normal(
        size=(2, 3, 32, 32)).astype(np.float32), ctx=CPU)

    def calls(fn):
        before = cbr.conv1x1_bn_relu.calls
        out = fn()
        return cbr.conv1x1_bn_relu.calls - before, out

    n, fused = calls(lambda: net(x))
    assert n == 4
    with tautograd.record(train_mode=False):
        n, plain = calls(lambda: net(x))
    assert n == 0
    np.testing.assert_allclose(fused.asnumpy(), plain.asnumpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(plain.asnumpy()).max())
    # training mode moves the moving statistics: after the comparison
    with tautograd.record():
        assert calls(lambda: net(x))[0] == 0
    with tautograd.train_mode():
        assert calls(lambda: net(x))[0] == 0
    for block in _batch_norms(net):
        block._use_global_stats = True
    with tautograd.train_mode():
        assert calls(lambda: net(x))[0] == 4
    assert fused.shape == (2, 10)


def _batch_norms(block):
    if isinstance(block, tnn.BatchNorm):
        yield block
    for child in block._children.values():
        yield from _batch_norms(child)


@pytest.mark.parametrize("layers", [
    lambda: (tnn.Conv2D(16, 1), tnn.BatchNorm()),
    lambda: (tnn.Conv2D(16, 1), tnn.BatchNorm(), tnn.Activation("sigmoid")),
    lambda: (tnn.Conv2D(16, 3, padding=1), tnn.BatchNorm(),
             tnn.Activation("relu")),
    lambda: (tnn.Conv2D(16, 1, padding=1), tnn.BatchNorm(),
             tnn.Activation("relu")),
    lambda: (tnn.Conv2D(16, 1, groups=2), tnn.BatchNorm(),
             tnn.Activation("relu")),
    lambda: (tnn.Conv2D(16, 1), tnn.BatchNorm(axis=2),
             tnn.Activation("relu")),
])
def test_fusion_skips_runs_that_do_not_match(layers):
    net = tnn.HybridSequential()
    net.add(*layers())
    net.initialize(ctx=CPU)
    before = cbr.conv1x1_bn_relu.calls
    y = net(tmx.nd.array(np.ones((1, 8, 16, 16), np.float32), ctx=CPU))
    assert cbr.conv1x1_bn_relu.calls == before
    assert np.isfinite(y.asnumpy()).all()


def test_fused_layers_initialize_deferred_parameters():
    """A 1×1 conv without ``in_channels`` and a BatchNorm without
    ``in_channels`` get their shapes on the fused path's first call."""
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(12, 1, strides=2), tnn.BatchNorm(),
            tnn.Activation("relu"))
    net.initialize(ctx=CPU)
    before = cbr.conv1x1_bn_relu.calls
    y = net(tmx.nd.array(np.ones((2, 5, 9, 9), np.float32), ctx=CPU))
    assert cbr.conv1x1_bn_relu.calls == before + 1
    assert y.shape == (2, 12, 5, 5)
    assert net[0].weight.shape == (12, 5, 1, 1)
    assert net[1].running_var.shape == (12,)


def test_kernel_wrapper_counts_nothing_on_the_cpu():
    x, w, scale, bias = map(torch.from_numpy, _operands(0, 8, 4, 4))
    before = cbr.fused_matmul_affine_relu.launches
    cbr.fused_matmul_affine_relu(x, w, scale, bias)
    assert cbr.fused_matmul_affine_relu.launches == before


def test_wrapper_launches_the_design_of_its_dtype(monkeypatch):
    """bf16 and f16 launch the tensor-core entry point (``_mma``), f32 the
    FMA one (``_fma``).  Driven with meta tensors and a stand-in library that
    records the C entry point the wrapper calls; ``.launches`` counts
    both designs, ``.launches_mma`` the tensor-core one."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            def entry(*args):
                calls.append(symbol)
                return 0
            return entry

    monkeypatch.setattr(_kernels, "load", lambda name: Lib())
    monkeypatch.setattr(cbr, "_check_kernel_operands", lambda *a: None)
    # meta tensors dispatch the custom op to its fake implementation: the
    # test reaches its CUDA implementation directly
    monkeypatch.setattr(cbr, "_fmar_op", cbr._fmar_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    fn = cbr.fused_matmul_affine_relu
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_mma", 0)
    for dtype, design in [(torch.bfloat16, "mma"), (torch.float32, "fma"),
                          (torch.bfloat16, "mma"), (torch.float16, "mma")]:
        x = torch.empty(6, 4, device="meta", dtype=dtype)
        w = torch.empty(4, 3, device="meta", dtype=dtype)
        affine = torch.empty(3, device="meta")
        out = fn(x, w, affine, affine)
        assert out.shape == (6, 3) and out.dtype == dtype
        assert calls[-1] == f"mxt_fused_matmul_affine_relu_{design}"
    assert (fn.launches, fn.launches_mma) == (4, 3)
    assert set(calls) == set(_kernels.SYMBOLS["fused_matmul_affine_relu"])


def test_fusion_in_float16_matches_the_layers():
    """After ``cast("float16")`` the narrow net's inference forward still
    takes the fusion (4 calls; on the card the f16 instance of the
    tensor-core kernel) and matches the same net's unfused layers.  Both
    round to f16 at other places (the fused path once after the affine,
    the layers after the conv and after BatchNorm), so they agree within
    a few f16 units of the logits' scale."""
    tmx.random.seed(5)
    net = _narrow_resnet()
    net.initialize(ctx=CPU)
    x = np.random.RandomState(2).normal(size=(2, 3, 32, 32))
    net(tmx.nd.array(x.astype(np.float32), ctx=CPU))
    net.cast("float16")
    xh = tmx.nd.array(x.astype(np.float16), ctx=CPU, dtype="float16")
    before = cbr.conv1x1_bn_relu.calls
    fused = net(xh)
    assert cbr.conv1x1_bn_relu.calls == before + 4
    with tautograd.record(train_mode=False):
        plain = net(xh)
    assert cbr.conv1x1_bn_relu.calls == before + 4
    assert fused.dtype == plain.dtype == torch.float16
    f, p = fused.asnumpy().astype(np.float32), plain.asnumpy().astype(
        np.float32)
    assert np.isfinite(f).all() and f.shape == (2, 10)
    assert np.abs(f - p).max() <= 8 * 2.0 ** -11 * np.abs(p).max()

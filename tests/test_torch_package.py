"""Package rules of the PyTorch/CUDA port: it imports neither JAX nor the
JAX package, it never falls back from the card to the CPU, and its
initializers draw on the parameter's device with an explicit
generator."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import context as mx_context
from mxnet_tpu_torch.gluon import nn

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mxnet_tpu_torch"


def test_import_pulls_in_no_jax_in_a_fresh_process():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.models.llama, "
            "mxnet_tpu_torch.convert, mxnet_tpu_torch._kernels\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), (f, mod)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_gpu_and_default_context_raise_without_a_card(no_card):
    with pytest.raises(mx.MXNetError, match="gpu"):
        mx.gpu(0)
    with pytest.raises(mx.MXNetError, match="gpu"):
        mx.current_context()
    with pytest.raises(mx.MXNetError):
        mx.nd.array([1.0, 2.0])
    net = nn.Dense(3, in_units=2)
    with pytest.raises(mx.MXNetError):
        net.initialize()
    assert mx.num_gpus() == 0


def test_explicit_cpu_runs_on_the_host(no_card):
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        x = mx.nd.array([[1.0, 2.0]])
        assert x.context == mx.cpu() and x._data.device.type == "cpu"
    assert mx_context.context_of(torch.device("cpu")) == mx.cpu()


def test_gpu_context_is_a_cuda_device():
    if mx.num_gpus() == 0:
        with pytest.raises(mx.MXNetError):
            mx.gpu(0)
        return
    assert mx.gpu(0).device == torch.device("cuda", 0)


def test_initializer_draws_on_device_in_dtype_from_seeded_generator():
    def make():
        mx.random.seed(123)
        net = nn.Dense(64, in_units=32, use_bias=True)
        net.cast("bfloat16")
        net.initialize(ctx=mx.cpu())
        return net

    a, b = make(), make()
    assert isinstance(a.weight.data()._data, torch.nn.Parameter)
    w = a.weight.data()._data.detach()
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    assert float(w.float().abs().max()) <= 0.07
    assert float(w.float().std()) > 0.02
    assert torch.equal(w, b.weight.data()._data)
    assert float(a.bias.data()._data.detach().abs().max()) == 0.0
    mx.random.seed(124)
    c = nn.Dense(64, in_units=32)
    c.initialize(ctx=mx.cpu())
    assert not torch.equal(c.weight.data()._data.float(), w.float())


def test_initializer_family():
    from mxnet_tpu_torch import initializer as init

    for ini, check in ((init.Zero(), lambda t: (t == 0).all()),
                       (init.One(), lambda t: (t == 1).all()),
                       (init.Constant(0.5), lambda t: (t == 0.5).all()),
                       (init.Normal(0.02),
                        lambda t: 0.01 < float(t.std()) < 0.03),
                       (init.create("uniform"),
                        lambda t: float(t.abs().max()) <= 0.07)):
        net = nn.Dense(50, in_units=40, use_bias=False)
        net.initialize(ini, ctx=mx.cpu())
        assert check(net.weight.data()._data.detach()), ini
    with pytest.raises(mx.MXNetError):
        init.create("no_such_init")


def test_ndarray_surface():
    with mx.cpu():
        x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        assert x.shape == (2, 3) and x.dtype == torch.float32
        y = (x + 1) * 2 - x / 2
        np.testing.assert_allclose(y.asnumpy(),
                                   (np.arange(6).reshape(2, 3) + 1) * 2 -
                                   np.arange(6).reshape(2, 3) / 2)
        assert mx.nd.argmax(x, axis=-1).asnumpy().tolist() == [2.0, 2.0]
        c = mx.nd.concat(x, x[:, :1], dim=1)
        assert c.shape == (2, 4)
        s = mx.nd.sigmoid(mx.nd.array([0.0, 0.0]))
        assert s.asnumpy().tolist() == [0.5, 0.5]
        assert x.astype("bfloat16").asnumpy().dtype == np.float32
        assert x.astype("int32").dtype == torch.int32

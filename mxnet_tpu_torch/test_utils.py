"""Test utilities.

Counterpart of ``mxnet_tpu/test_utils.py`` (reference
``python/mxnet/test_utils.py``): ``check_numeric_gradient`` (central
differences against the tape's gradient), the dtype-aware
``assert_almost_equal``, the random array helpers, ``with_seed``,
``max_rel_err`` and ``check_consistency``, which runs one function under
each context of a list and holds the outputs to the first's:
``check_consistency(fn, inputs, [mx.cpu(), mx.gpu(0)])`` is the port's
card-against-host lane.  ``default_context()`` is the innermost ``with
ctx:`` scope, else ``mx.gpu(0)`` where a card is present and
``mx.cpu()`` where none is.
"""
from __future__ import annotations

import numpy as np

from .ndarray import NDArray
from . import ndarray as nd
from . import autograd


def default_context():
    import torch

    from .context import Context, cpu, gpu

    if getattr(Context._local, "stack", None):
        return Context.default_ctx()
    return gpu(0) if torch.cuda.is_available() else cpu(0)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a = a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)
    b = b.asnumpy() if isinstance(b, NDArray) else np.asarray(b)
    dt = np.result_type(a.dtype, b.dtype)
    if rtol is None:
        rtol = {np.dtype(np.float64): 1e-7, np.dtype(np.float32): 1e-4,
                np.dtype(np.float16): 1e-2}.get(np.dtype(dt), 1e-3)
    if atol is None:
        atol = {np.dtype(np.float64): 1e-9, np.dtype(np.float32): 1e-5,
                np.dtype(np.float16): 1e-3}.get(np.dtype(dt), 1e-4)
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                               rtol=rtol, atol=atol,
                               err_msg=f"{names[0]} vs {names[1]}")


def rand_ndarray(shape, dtype=np.float32, scale=1.0, ctx=None):
    return nd.array(np.random.uniform(-scale, scale, size=shape)
                    .astype(dtype), ctx=ctx or default_context())


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3,
                           ctx=None):
    """Central differences of ``sum(fn(*inputs))`` against its autograd
    gradient, in float64 on ``ctx`` (default: ``default_context()``).

    ``fn``: NDArray... -> NDArray; ``inputs``: numpy arrays."""
    ctx = ctx or default_context()
    inputs = [np.asarray(x, dtype=np.float64) for x in inputs]
    nds = [nd.array(x, ctx=ctx, dtype=np.float64) for x in inputs]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        loss = fn(*nds).sum()
    loss.backward()
    analytic = [x.grad.asnumpy() for x in nds]

    def eval_at(vals):
        with autograd.pause():
            return float(fn(*[nd.array(v, ctx=ctx, dtype=np.float64)
                              for v in vals]).sum().asscalar())

    for i, base in enumerate(inputs):
        num = np.zeros_like(base)
        it = np.nditer(base, flags=["multi_index"])
        for _ in it:
            idx = it.multi_index
            vp = [v.copy() for v in inputs]
            vp[i][idx] += eps
            vm = [v.copy() for v in inputs]
            vm[i][idx] -= eps
            num[idx] = (eval_at(vp) - eval_at(vm)) / (2 * eps)
        np.testing.assert_allclose(analytic[i], num, rtol=rtol, atol=atol,
                                   err_msg=f"gradient mismatch on input {i}")


def with_seed(seed=None):
    """Decorator: run the test under a fixed (or a fresh random) seed of
    numpy and ``mx.random`` and print it when the test fails
    (``MXNET_TEST_SEED`` sets it; an explicit ``seed`` wins)."""
    import functools
    import os

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            env = os.environ.get("MXNET_TEST_SEED")
            s = (seed if seed is not None
                 else int(env) if env is not None
                 else np.random.randint(0, np.iinfo(np.int32).max))
            np.random.seed(s)
            from . import random as mx_random

            mx_random.seed(s)
            try:
                return fn(*args, **kwargs)
            except Exception:
                print(f"with_seed: test failed with seed {s} "
                      f"(reproduce with MXNET_TEST_SEED={s})")
                raise

        return wrapper

    return deco


def max_rel_err(a, b, atol=0.0):
    """``max(|a-b| / (|a| + max(atol, 1e-12)))``; NaN on both sides
    agrees, NaN on one side is ``inf``."""
    if np.asarray(a).size == 0:
        return 0.0
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    e = np.abs(a - b) / (np.abs(a) + max(atol, 1e-12))
    both_nan = np.isnan(a) & np.isnan(b)
    e = np.where(both_nan, 0.0, e)
    if np.isnan(e).any():
        return float("inf")
    return float(np.max(e))


def check_consistency(fn, inputs, ctxs=None, rtol=1e-4, atol=1e-5,
                      collect=None, ref=None):
    """Run ``fn`` on ``inputs`` (numpy arrays) under each context of
    ``ctxs`` (default ``[mx.cpu(0)]``) and hold every output to the
    first's (or to ``ref``); ``collect`` receives the worst
    ``max_rel_err``.  Returns the reference output."""
    from .context import cpu

    ctxs = ctxs or [cpu(0)]
    outs = []
    for ctx in ctxs:
        with ctx:
            nds = [nd.array(x, ctx=ctx) for x in inputs]
            outs.append(fn(*nds).asnumpy())
    if ref is None:
        ref, others = outs[0], outs[1:]
    else:
        ref, others = np.asarray(ref), outs
    if collect is not None:
        collect(max((max_rel_err(ref, o, atol) for o in others),
                    default=0.0))
    for o in others:
        np.testing.assert_allclose(ref, o, rtol=rtol, atol=atol)
    return ref

"""Random number state.

Counterpart of ``mxnet_tpu/random.py`` (reference ``mx.random.seed``).
Each device has its own ``torch.Generator``; every draw in the package
names the generator of the device it draws on (``generator(device)``),
so the global torch RNG is never consulted.  ``seed()`` re-seeds every
device's generator; a device seen for the first time after that gets a
generator seeded with the same value, as the reference seeds each
device's random resource.  ``get_state``/``set_state`` carry the seed and
the generators' states through a checkpoint.  A device's generator stays
the same object for the life of the thread: ``seed`` and ``set_state``
re-seed and restore it in place, because a captured CUDA graph replays
with the generator object it registered (``cuda_graph.capture``) and
reads that object's seed and offset at each replay.  (The reference's
per-context ``seed(s, ctx)`` is not ported: no caller needs it yet.)

The samplers (``uniform``, ``normal``, ``randint``, ``exponential``,
``gamma``, ``poisson``, ``multinomial``, ``shuffle``, ``bernoulli``) draw
on the generator of the device they fill, on ``ctx`` (default: the
current context) or the input's device.  Their streams are torch's, not
the reference's jax keys: the same seed gives the same draws here, not
the reference's values.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from .base import MXNetError


class _RandState(threading.local):
    def __init__(self):
        self.seed = None
        self.generators = {}


_STATE = _RandState()


def _base_seed() -> int:
    if _STATE.seed is None:
        _STATE.seed = int(os.environ.get("MXNET_SEED",
                                         np.random.randint(0, 2**31)))
    return _STATE.seed


def seed(seed_state: int, ctx="all"):
    """Reference ``mx.random.seed``: re-seed every device's generator
    and numpy's global stream, or with ``ctx`` a Context only that
    device's generator (in place: a captured graph keeps drawing from
    it)."""
    if ctx != "all":
        generator(ctx.device).manual_seed(int(seed_state))
        return
    _STATE.seed = int(seed_state)
    for gen in _STATE.generators.values():
        gen.manual_seed(_STATE.seed)
    np.random.seed(_STATE.seed % (2**32))


def next_key():
    """JAX's PRNG key plumbing has no counterpart: the port draws from
    torch generators (``generator``)."""
    raise MXNetError("random.next_key (JAX PRNG keys) is not carried over "
                     "(ROADMAP.md, \"Not carried over\"); the port draws "
                     "from torch generators, random.generator(device)")


class key_provider:
    """JAX's counter-based key provider has no counterpart (see
    ``next_key``)."""

    def __init__(self, *args, **kwargs):
        next_key()


def generator(device) -> torch.Generator:
    """The ``torch.Generator`` that draws on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _STATE.generators.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_base_seed())
        _STATE.generators[dev] = gen
    return gen


def get_state():
    """The package's random state: the seed and each device generator's
    state (a checkpoint saves it, ``set_state`` restores it)."""
    return {"seed": _STATE.seed,
            "generators": {str(dev): gen.get_state().numpy().copy()
                           for dev, gen in _STATE.generators.items()}}


def set_state(state):
    """Restore ``get_state()``'s result in place: the seed, the
    generators of the devices it names (created if this thread has not
    drawn on them yet), and every other device's generator re-seeded
    with the seed, as a first draw after ``seed`` would find it."""
    _STATE.seed = state["seed"]
    saved = {torch.device(dev): arr
             for dev, arr in state["generators"].items()}
    for dev, gen in _STATE.generators.items():
        if dev not in saved:
            gen.manual_seed(_base_seed())
    for dev, arr in saved.items():
        generator(dev).set_state(torch.from_numpy(np.array(arr,
                                                           dtype=np.uint8)))


# --- samplers (reference src/operator/random/sample_op.cc) ------------------

def _sample(fn, shape, dtype, ctx, out=None, default=torch.float32):
    from .base import resolve_dtype
    from .context import current_context
    from .ndarray.ndarray import NDArray

    shape = (shape,) if isinstance(shape, int) else tuple(shape or ())
    device = (ctx or current_context()).device
    raw = fn(shape, resolve_dtype(dtype) or default, device,
             generator(device))
    if out is not None:
        out._data = raw
        return out
    return NDArray(raw)


def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None, out=None,
            **kwargs):
    """U[low, high) of ``shape``."""
    return _sample(lambda s, dt, dev, g: torch.rand(
        s, generator=g, device=dev, dtype=dt) * (high - low) + low,
        shape, dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None, out=None,
           **kwargs):
    """N(loc, scale²) of ``shape``."""
    return _sample(lambda s, dt, dev, g: loc + scale * torch.randn(
        s, generator=g, device=dev, dtype=dt), shape, dtype, ctx, out)


randn = normal


def randint(low, high, shape=(1,), dtype=None, ctx=None, out=None,
            **kwargs):
    """Integers in [low, high), int32 unless ``dtype`` says otherwise."""
    return _sample(lambda s, dt, dev, g: torch.randint(
        low, high, s, generator=g, device=dev, dtype=dt), shape, dtype, ctx,
        out, default=torch.int32)


def exponential(scale=1.0, shape=(1,), dtype=None, ctx=None, out=None,
                **kwargs):
    """Exponential with mean ``scale``."""
    return _sample(lambda s, dt, dev, g: scale * torch.empty(
        s, device=dev, dtype=dt).exponential_(1.0, generator=g), shape,
        dtype, ctx, out)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None, out=None,
          **kwargs):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return _sample(lambda s, dt, dev, g: beta * torch._standard_gamma(
        torch.full(s, float(alpha), device=dev, dtype=dt), generator=g),
        shape, dtype, ctx, out)


def poisson(lam=1.0, shape=(1,), dtype=None, ctx=None, out=None, **kwargs):
    """Poisson with rate ``lam``."""
    return _sample(lambda s, dt, dev, g: torch.poisson(
        torch.full(s, float(lam), device=dev), generator=g).to(dt),
        shape, dtype, ctx, out)


def bernoulli(prob=0.5, shape=(1,), dtype=None, ctx=None, **kwargs):
    """1 with probability ``prob``, else 0."""
    return _sample(lambda s, dt, dev, g: (torch.rand(
        s, generator=g, device=dev) < prob).to(dt), shape, dtype, ctx)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kwargs):
    """Category indices drawn from each row of probabilities ``data``
    (..., C): ``shape`` draws a row (the last axis dropped when 1), and
    with ``get_prob`` the log-probabilities of the draws."""
    from . import ndarray as nd
    from .base import resolve_dtype
    from .ndarray.ndarray import NDArray

    n = shape if isinstance(shape, int) else int(np.prod(shape))
    p = data._data.detach().float()
    rows = p.reshape(-1, p.shape[-1])
    idx = torch.multinomial(rows, n, replacement=True,
                            generator=generator(p.device))
    idx = idx.reshape(p.shape[:-1] + (n,))
    if n == 1:
        idx = idx[..., 0]
    out = NDArray(idx.to(resolve_dtype(dtype)))
    if get_prob:
        return out, nd.log(nd.pick(data, out.astype("float32"), axis=-1))
    return out


sample_multinomial = multinomial


def shuffle(data, **kwargs):
    """``data`` with its first axis permuted at random."""
    from .ops.registry import apply_op

    dev = data._data.device
    perm = torch.randperm(data.shape[0], generator=generator(dev),
                          device=dev)
    return apply_op(lambda a: a.index_select(0, perm), data, name="shuffle")

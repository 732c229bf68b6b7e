"""Random number state.

Counterpart of ``mxnet_tpu/random.py`` (reference ``mx.random.seed``).
Each device has its own ``torch.Generator``; every draw in the package
names the generator of the device it draws on (``generator(device)``),
so the global torch RNG is never consulted.  ``seed()`` re-seeds every
device's generator; a device seen for the first time after that gets a
generator seeded with the same value, as the reference seeds each
device's random resource.  (The reference's per-context ``seed(s,
ctx)`` is not ported: no caller needs it yet.)
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch


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


def seed(seed_state: int):
    """Reference ``mx.random.seed``: re-seed every device's generator
    and numpy's global stream."""
    _STATE.seed = int(seed_state)
    _STATE.generators = {}
    np.random.seed(_STATE.seed % (2**32))


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

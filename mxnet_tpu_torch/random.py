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
    for gen in _STATE.generators.values():
        gen.manual_seed(_STATE.seed)
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

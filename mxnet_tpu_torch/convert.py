"""Weight transfer from numpy arrays.

Fills a net's parameters from ``{structural name: np.ndarray}``, keyed by
the names ``Block._collect_params_with_prefix`` gives
(``model.layers.0.self_attn.q_proj.weight``): those depend only on the
block structure, while the counter-based prefixes differ between two
processes' name managers.  It stands in for ``.params`` loading until
``serialization.py`` ports (ROADMAP Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import current_context
from . import initializer as init_mod


def load_numpy_params(net, arrays, ctx=None):
    """Copy ``arrays`` into ``net``'s parameters, each in the parameter's
    dtype, on ``ctx`` (default: the current context) for parameters not
    yet initialized.  Raises ``MXNetError`` on a missing, extra or
    mis-shaped name before anything is written."""
    params = net._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"load_numpy_params: missing {missing}, "
                         f"extra {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(arrays[name]))
        if p.shape is None or len(p.shape) != len(shape) or any(
                have > 0 and have != got
                for have, got in zip(p.shape, shape)):
            raise MXNetError(f"load_numpy_params: {name!r} has shape "
                             f"{shape}, the parameter {p.shape}")
    ctx = ctx or current_context()
    for name, p in params.items():
        value = torch.from_numpy(np.array(arrays[name]))  # own copy
        if p._data is None:
            p.shape = tuple(value.shape)
            p.initialize(init=init_mod.Zero(), ctx=ctx)
        p.set_data(value)

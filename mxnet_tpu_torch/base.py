"""Foundations: the framework error type and dtype handling.

Counterpart of ``mxnet_tpu/base.py``.  Errors are ordinary Python
exceptions; dtypes are ``torch.dtype`` objects, with the MXNet spellings
(strings, numpy dtypes) accepted at every public entry point.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


class MXNetError(RuntimeError):
    """Framework error type (reference: ``mxnet.base.MXNetError``)."""


_DTYPE_ALIASES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def resolve_dtype(dtype: Any):
    """Normalise a user-supplied dtype (string, numpy dtype or type, torch
    dtype) to a ``torch.dtype``; ``None`` passes through."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _DTYPE_ALIASES:
            raise MXNetError(f"unknown dtype {dtype!r}")
        return _DTYPE_ALIASES[dtype]
    name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise MXNetError(f"unsupported dtype {name!r}")
    return _DTYPE_ALIASES[name]

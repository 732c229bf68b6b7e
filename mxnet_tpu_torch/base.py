"""Foundations: the framework error type, dtype handling and the small
helpers of the reference's ``base`` (``check``, ``normalize_shape``, the
``getenv_*`` readers and ``gen_name``).

Counterpart of ``mxnet_tpu/base.py``.  Errors are ordinary Python
exceptions; dtypes are ``torch.dtype`` objects, with the MXNet spellings
(strings, numpy dtypes) accepted at every public entry point.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


class MXNetError(RuntimeError):
    """Framework error type (reference: ``mxnet.base.MXNetError``)."""


def check(cond: bool, msg: str = "") -> None:
    """CHECK-style assertion: raises ``MXNetError`` when ``cond`` is
    false."""
    if not cond:
        raise MXNetError(msg or "Check failed")


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


def dtype_name(dtype: Any) -> str:
    """The numpy-style name of a dtype (``"float32"``, ``"bfloat16"``)."""
    dt = resolve_dtype(dtype)
    return str(dt).removeprefix("torch.")


def normalize_shape(shape) -> tuple:
    """A shape as a tuple of ints (an int is a 1-d shape; None stays)."""
    if shape is None:
        return None
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def getenv_int(name: str, default: int) -> int:
    """An integer environment variable, ``default`` when unset or not an
    integer."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def getenv_bool(name: str, default: bool) -> bool:
    """A boolean environment variable (1/true/yes/on), ``default`` when
    unset."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


_NAME_COUNTER = [0]


def gen_name(prefix: str) -> str:
    """Sequential unique names: ``prefix`` and a process-wide count."""
    _NAME_COUNTER[0] += 1
    return f"{prefix}{_NAME_COUNTER[0]}"

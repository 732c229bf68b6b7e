"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference
``python/mxnet/gluon/utils.py``): ``split_data``/``split_and_load`` (a
batch sliced across a list of contexts), ``clip_global_norm``,
``check_sha1``, ``shape_is_known`` and ``HookHandle``.  ``download``
raises: nothing is fetched over a network.
"""
from __future__ import annotations

import hashlib
import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context
from ..ndarray import NDArray


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` in ``num_slice`` slices along ``batch_axis`` (the last
    takes the remainder when ``even_split`` is False)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(f"batch size {size} not divisible by {num_slice} "
                         "slices; set even_split=False")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of the batch on each context of ``ctx_list``.  With a
    mesh active and more than one context, the batch becomes one
    ``dp``-sharded array (``parallel.shard_batch``), returned as a
    one-element list, as the reference returns one sharded array."""
    if not isinstance(data, NDArray):
        data = NDArray(np.asarray(data), ctx=ctx_list[0]
                       if not isinstance(ctx_list, Context) else ctx_list)
    if isinstance(ctx_list, Context):
        ctx_list = [ctx_list]
    if len(ctx_list) > 1:
        from .. import parallel

        mesh = parallel.current_mesh()
        if mesh is not None:
            return [parallel.shard_batch(data, mesh, axis=batch_axis)]
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float, or an NDArray
    when not ``check_isfinite``)."""
    if not arrays:
        raise MXNetError("no arrays to clip")
    with torch.no_grad():
        total = torch.sqrt(sum(torch.square(a._data.float()).sum()
                               for a in arrays))
        total_f = float(total) if check_isfinite else None
        if check_isfinite and not np.isfinite(total_f):
            warnings.warn("nan or inf found in clip_global_norm")
            return total_f
        scale = torch.clamp(max_norm / (total + 1e-12), max=1.0)
        for a in arrays:
            a._data = (a._data * scale).to(a.dtype)
    return total_f if check_isfinite else NDArray(total)


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Raises: nothing is fetched over a network (as in the reference)."""
    raise MXNetError(
        "download() requires network access, which this package does not "
        "use; place files locally and pass their path instead")


def shape_is_known(shape):
    return shape is not None and all(s > 0 for s in shape)


class HookHandle:
    """A removable handle of a registered hook."""

    _next_id = 0

    def __init__(self):
        self._hooks_dict = None
        self._id = None

    def attach(self, hooks_dict, hook):
        self._id = HookHandle._next_id
        HookHandle._next_id += 1
        hooks_dict[self._id] = hook
        self._hooks_dict = hooks_dict

    def detach(self):
        if self._hooks_dict is not None and self._id in self._hooks_dict:
            del self._hooks_dict[self._id]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()

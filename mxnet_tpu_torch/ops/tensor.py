"""Tensor structure, reduction, indexing, ordering, sequence, matmul and
linalg ops.

Counterpart of ``mxnet_tpu/ops/tensor.py``, with its names and aliases.
Each op is a torch call on the operands.  Index outputs (``argmax``,
``argsort``, ``topk``'s indices) are float32 and carry no gradient, as
the reference's; ``topk`` and ``argsort`` order ties by index (a stable
sort), as ``lax.top_k`` and ``jnp.argsort`` do.  ``dot``/``batch_dot``
on bf16/f16 operands accumulate in f32 and keep their gradients in the
operands' dtype (``nn_ops.mxu_matmul_nt``/``mxu_batch_matmul``).  The
decompositions (``linalg_gelqf``, ``linalg_syevd``, ``linalg_gesvd``)
are LAPACK's: a factor's signs may differ from another library's, its
products do not.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as tnf

from ..base import MXNetError, resolve_dtype
from .registry import apply_op, exporter
from .registry import commit_out, make_exporter  # noqa: F401
from .nn_ops import Flatten, flatten  # noqa: F401  (the reference's home)

__all__ = []
_export = exporter(__all__)

_LOW = (torch.float16, torch.bfloat16)


# --- shape manipulation -----------------------------------------------------

def _mx_reshape_target(in_shape, spec):
    """The reference's reshape codes against ``in_shape``: 0 copies the
    input dim at the cursor, -1 infers one dim, -2 copies every remaining
    input dim, -3 merges the next two, -4 splits one into the two values
    that follow (one may be -1); a positive value consumes one dim."""
    out, src, j, infer_at = [], 0, 0, None
    spec = [int(s) for s in spec]
    while j < len(spec):
        s = spec[j]
        if s == 0:
            if src >= len(in_shape):
                raise MXNetError(f"reshape code 0 at {j} has no input dim")
            out.append(in_shape[src])
            src += 1
        elif s == -1:
            if infer_at is not None:
                raise MXNetError("reshape allows at most one -1")
            infer_at = len(out)
            out.append(-1)
            src += 1
        elif s == -2:
            out.extend(in_shape[src:])
            src = len(in_shape)
        elif s == -3:
            if src + 2 > len(in_shape):
                raise MXNetError("reshape code -3 needs two input dims")
            out.append(in_shape[src] * in_shape[src + 1])
            src += 2
        elif s == -4:
            if j + 2 >= len(spec) or src >= len(in_shape):
                raise MXNetError("reshape code -4 needs an input dim and two "
                                 "following values")
            d, d1, d2 = in_shape[src], spec[j + 1], spec[j + 2]
            if d1 == -1 and d2 == -1:
                raise MXNetError("reshape -4: both split factors are -1")
            if (d1 != -1 and d1 <= 0) or (d2 != -1 and d2 <= 0):
                raise MXNetError("reshape -4: split factors must be "
                                 f"positive or -1, got ({d1}, {d2})")
            d1 = d // d2 if d1 == -1 else d1
            d2 = d // d1 if d2 == -1 else d2
            if d1 * d2 != d:
                raise MXNetError(f"reshape -4: {d1}x{d2} != input dim {d}")
            out.extend([d1, d2])
            src += 1
            j += 2
        elif s > 0:
            out.append(s)
            src += 1
        else:
            raise MXNetError(f"bad reshape code {s}")
        j += 1
    if infer_at is not None:
        known = int(np.prod([v for v in out if v != -1]))
        total = int(np.prod(in_shape))
        if known == 0 or total % known:
            raise MXNetError(f"cannot infer -1: {in_shape} -> {tuple(out)}")
        out[infer_at] = total // known
    return tuple(out)


def reshape(data, shape=None, reverse=False, **kwargs):
    """Reference ``reshape`` with the codes 0, -1, -2, -3 and -4
    (``_mx_reshape_target``); ``reverse`` resolves them right to left."""
    if shape is None:
        raise MXNetError("reshape needs target shape")
    if reverse:
        tgt = _mx_reshape_target(data.shape[::-1], list(shape)[::-1])[::-1]
    else:
        tgt = _mx_reshape_target(data.shape, shape)
    return apply_op(lambda a: a.reshape(tgt), data, name="reshape")


_export(reshape, aliases=("Reshape",))


def reshape_like(lhs, rhs, **kwargs):
    """Reference ``reshape_like``: ``lhs`` in the shape of ``rhs``."""
    tgt = rhs.shape
    return apply_op(lambda a: a.reshape(tgt), lhs, name="reshape_like")


_export(reshape_like)


def transpose(data, axes=None, **kwargs):
    """Reference ``transpose``: permute the axes (reverse them when
    ``axes`` is None or empty)."""
    def f(a):
        return a.permute(*(tuple(axes) if axes else
                           reversed(range(a.ndim))))

    return apply_op(f, data, name="transpose")


_export(transpose)


def zeros_like(data, **kwargs):
    return apply_op(torch.zeros_like, data, name="zeros_like")


def ones_like(data, **kwargs):
    return apply_op(torch.ones_like, data, name="ones_like")


_export(zeros_like)
_export(ones_like)


def swapaxes(data, dim1=0, dim2=1, **kwargs):
    """Reference ``SwapAxis``: exchange axes ``dim1`` and ``dim2``."""
    return apply_op(lambda a: torch.swapaxes(a, dim1, dim2), data,
                    name="swapaxes")


_export(swapaxes, aliases=("SwapAxis",))


def expand_dims(data, axis, **kwargs):
    """Reference ``expand_dims``: a length-1 axis inserted at ``axis``."""
    return apply_op(lambda a: a.unsqueeze(axis), data, name="expand_dims")


_export(expand_dims)


def squeeze(data, axis=None, **kwargs):
    """Reference ``squeeze``: drop the length-1 axes (all, or those of
    ``axis``, an int or a tuple)."""
    def f(a):
        if axis is None:
            return a.squeeze()
        return a.squeeze(axis if isinstance(axis, int) else tuple(axis))

    return apply_op(f, data, name="squeeze")


_export(squeeze)


def broadcast_to(data, shape=None, **kwargs):
    """Reference ``broadcast_to`` (0 keeps the input dim)."""
    in_shape = data.shape
    tgt = tuple(i if s == 0 else int(s) for i, s in zip(in_shape, shape)) \
        if len(shape) == len(in_shape) else tuple(shape)
    return apply_op(lambda a: a.expand(tgt), data, name="broadcast_to")


_export(broadcast_to)


def broadcast_like(lhs, rhs, **kwargs):
    """Reference ``broadcast_like``: ``lhs`` broadcast to ``rhs``'s
    shape."""
    tgt = rhs.shape
    return apply_op(lambda a: a.expand(tgt), lhs, name="broadcast_like")


_export(broadcast_like)


def broadcast_axis(data, axis=None, size=None, **kwargs):
    """Reference ``broadcast_axis``: the given length-1 axes widened to
    ``size``."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for ax, s in zip(axes, sizes):
        tgt[ax] = s
    tgt = tuple(tgt)
    return apply_op(lambda a: a.expand(tgt), data, name="broadcast_axis")


_export(broadcast_axis, aliases=("broadcast_axes",))


def tile(data, reps, **kwargs):
    """Reference ``tile``: the whole array repeated ``reps`` times per
    axis."""
    return apply_op(lambda a: torch.tile(a, tuple(reps)), data, name="tile")


_export(tile)


def repeat(data, repeats, axis=None, **kwargs):
    """Reference ``repeat``: each element ``repeats`` times along ``axis``
    (of the flattened array when None)."""
    return apply_op(lambda a: torch.repeat_interleave(a, repeats, dim=axis),
                    data, name="repeat")


_export(repeat)


def flip(data, axis, **kwargs):
    """Reference ``reverse``: element order reversed along ``axis``."""
    dims = (axis,) if isinstance(axis, int) else tuple(axis)
    return apply_op(lambda a: torch.flip(a, dims), data, name="flip")


_export(flip, aliases=("reverse",))


def pad(data, mode="constant", pad_width=None, constant_value=0, **kwargs):
    """Reference ``Pad``: ``pad_width`` as (begin, end) pairs for every
    axis; ``"edge"`` and ``"reflect"`` pad only the trailing spatial
    axes (the pairs of N and C are 0), as the reference's op does."""
    pairs = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
             for i in range(len(pad_width) // 2)]
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError(f"pad: unknown mode {mode!r}")
    if mode != "constant":
        if any(p for pr in pairs[:2] for p in pr):
            raise MXNetError(f"pad: mode {mode!r} pads the spatial axes "
                             "only")
        pairs = pairs[2:]
    flat = [p for pr in reversed(pairs) for p in pr]

    def f(a):
        if mode == "constant":
            return tnf.pad(a, flat, value=constant_value)
        return tnf.pad(a, flat,
                       mode="replicate" if mode == "edge" else "reflect")

    return apply_op(f, data, name="pad")


_export(pad, aliases=("Pad",))


def _arrays(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return tuple(args[0])
    return args


def concat(*args, dim=1, out=None, **kwargs):
    """Reference ``Concat``: join arrays along existing axis ``dim``."""
    return apply_op(lambda *raws: torch.cat(raws, dim=dim), *_arrays(args),
                    name="concat")


_export(concat, aliases=("Concat", "concatenate"))


def stack(*args, axis=0, out=None, **kwargs):
    """Reference ``stack``: join arrays along a new axis ``axis``."""
    return apply_op(lambda *raws: torch.stack(raws, dim=axis),
                    *_arrays(args), name="stack")


_export(stack)


def split(data, num_outputs=None, axis=1, squeeze_axis=False, **kwargs):
    """Reference ``SliceChannel``: ``num_outputs`` equal parts along
    ``axis``, as a list."""
    n = int(num_outputs)
    if data.shape[axis] % n:
        raise MXNetError(f"split: axis {axis} of {data.shape} does not "
                         f"divide into {n}")

    def f(a):
        parts = torch.chunk(a, n, dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)

    return list(apply_op(f, data, name="split"))


_export(split, aliases=("SliceChannel",))


def _index_key(a, key):
    """``a[key]`` for a tuple of slices; a negative step (torch slicing
    has none) takes the indices it names."""
    if all(k.step is None or k.step > 0 for k in key):
        return a[key]
    for ax, k in enumerate(key):
        idx = torch.arange(*k.indices(a.shape[ax]), device=a.device)
        a = a.index_select(ax, idx)
    return a


def slice(data, begin, end, step=None, **kwargs):  # noqa: A001
    """Reference ``slice``: begin, end and step per axis; None keeps an
    axis whole."""
    nd = data.ndim
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step) + (None,) * (nd - len(step)) if step else (None,) * nd
    key = tuple(builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))
    return apply_op(lambda a: _index_key(a, key), data, name="slice")


_export(slice, name="slice", aliases=("crop",))


def slice_axis(data, axis=0, begin=0, end=None, **kwargs):
    """Reference ``slice_axis``: ``[begin, end)`` along one axis."""
    key = [builtins.slice(None)] * data.ndim
    key[axis] = builtins.slice(begin, end)
    key = tuple(key)
    return apply_op(lambda a: a[key], data, name="slice_axis")


_export(slice_axis)


def slice_like(data, shape_like, axes=None, **kwargs):
    """Reference ``slice_like``: ``data`` cut to ``shape_like``'s extents
    on ``axes`` (every shared axis when None)."""
    tgt = shape_like.shape
    key = [builtins.slice(None)] * data.ndim
    for ax in (axes if axes is not None else range(min(data.ndim,
                                                           len(tgt)))):
        key[ax] = builtins.slice(0, tgt[ax])
    key = tuple(key)
    return apply_op(lambda a: a[key], data, name="slice_like")


_export(slice_like)


def where(condition, x, y, **kwargs):
    """Reference ``where``: ``x`` where ``condition`` is nonzero, else
    ``y``."""
    return apply_op(lambda c, a, b: torch.where(c != 0, a, b), condition, x,
                    y, name="where")


_export(where)


def clip(data, a_min=None, a_max=None, **kwargs):
    """Reference ``clip``: values clamped into ``[a_min, a_max]``."""
    return apply_op(lambda a: torch.clamp(a, a_min, a_max), data,
                    name="clip")


_export(clip)


def cast(data, dtype, **kwargs):
    """Reference ``Cast``: a copy in ``dtype``."""
    dt = resolve_dtype(dtype)
    return apply_op(lambda a: a.to(dt), data, name="cast")


_export(cast, aliases=("Cast",))


def diag(data, k=0, **kwargs):
    """Reference ``diag``: the k-th diagonal of a matrix (of the last two
    axes), or the matrix of a vector's diagonal."""
    return apply_op(lambda a: torch.diag(a, k) if a.ndim <= 2 else
                    torch.diagonal(a, k, -2, -1), data, name="diag")


_export(diag)


# --- reductions -------------------------------------------------------------

def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return None
    ax = (int(axis),) if isinstance(axis, int) else tuple(int(a)
                                                          for a in axis)
    ax = tuple(a % ndim for a in ax) if ndim else ax
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _prod(a, ax, keepdims):
    if ax is None:
        out = a.prod()
        return out.reshape((1,) * a.ndim) if keepdims else out
    for d in sorted(ax, reverse=True):
        a = a.prod(dim=d, keepdim=keepdims)
    return a


def _int_back(fn):
    """jnp keeps an integer array's dtype through sum/prod (torch widens
    to int64)."""
    def g(a, ax, keepdims):
        out = fn(a, ax, keepdims)
        if not a.is_floating_point() and a.dtype != torch.bool:
            out = out.to(a.dtype)
        return out

    return g


def _mean(a, ax, keepdims):
    if not a.is_floating_point():
        a = a.float()
    return a.mean() if ax is None else a.mean(dim=ax, keepdim=keepdims)


def _whole(fn):
    def g(a, ax, keepdims):
        if ax is None:
            out = fn(a)
            return out.reshape((1,) * a.ndim) if keepdims else out
        return fn(a, dim=ax, keepdim=keepdims)

    return g


_REDUCE = {
    "sum": _int_back(_whole(torch.sum)),
    "nansum": _int_back(_whole(torch.nansum)),
    "mean": _mean,
    "prod": _int_back(_prod),
    "nanprod": lambda a, ax, kd: _prod(
        torch.where(torch.isnan(a), torch.ones_like(a), a), ax, kd),
    "max": _whole(torch.amax),
    "min": _whole(torch.amin),
}


def _make_reduce(name, aliases=()):
    rf = _REDUCE[name]

    def fn(data, axis=None, keepdims=False, exclude=False, out=None, **kw):
        ax = _norm_axis(axis, data.ndim, exclude)

        def f(a):
            if ax == ():
                return a + 0
            return rf(a, ax, keepdims)

        return apply_op(f, data, name=name)

    fn.__name__ = name
    fn.__doc__ = (f"Reference ``{name}``: reduce over ``axis`` "
                  "(``exclude=True`` reduces every other axis).")
    _export(fn, name, aliases)


_make_reduce("sum", ("sum_axis",))
_make_reduce("nansum")
_make_reduce("mean")
_make_reduce("prod")
_make_reduce("nanprod")
_make_reduce("max", ("max_axis",))
_make_reduce("min", ("min_axis",))


def norm(data, ord=2, axis=None, keepdims=False, out=None, **kwargs):
    """Reference ``norm``: L1 or L2 (Frobenius) norm over ``axis``, summed
    in f32 for bf16/f16 input and returned in the input's dtype."""
    ax = _norm_axis(axis, data.ndim)

    def f(a):
        af = a.float() if a.dtype in _LOW else a
        r = torch.abs(af) if ord == 1 else torch.square(af)
        r = r.sum() if ax is None else r.sum(dim=ax, keepdim=keepdims)
        if ax is None and keepdims:
            r = r.reshape((1,) * a.ndim)
        if ord != 1:
            r = torch.sqrt(r)
        return r.to(a.dtype)

    return apply_op(f, data, name="norm")


_export(norm)


def _arg(fn):
    def g(a, axis, keepdims):
        if axis is None:
            out = fn(a.reshape(-1), 0)
            return out.reshape((1,) * a.ndim) if keepdims else out
        return fn(a, axis, keepdim=keepdims)

    return g


def argmax(data, axis=None, keepdims=False, **kwargs):
    """Reference ``argmax``: index of the (first) maximum along ``axis``,
    as float32."""
    return apply_op(lambda a: _arg(torch.argmax)(a, axis, keepdims).float(),
                    data, name="argmax", no_grad=True)


def argmin(data, axis=None, keepdims=False, **kwargs):
    """Reference ``argmin``: index of the (first) minimum along ``axis``,
    as float32."""
    return apply_op(lambda a: _arg(torch.argmin)(a, axis, keepdims).float(),
                    data, name="argmin", no_grad=True)


_export(argmax, no_grad=True)
_export(argmin, no_grad=True)


def argsort(data, axis=-1, is_ascend=True, dtype=np.float32, **kwargs):
    """Reference ``argsort``: the stable sorting permutation along
    ``axis``."""
    dt = resolve_dtype(dtype)
    return apply_op(lambda a: torch.argsort(a if is_ascend else -a, dim=axis,
                                            stable=True).to(dt),
                    data, name="argsort", no_grad=True)


_export(argsort, no_grad=True)


def sort(data, axis=-1, is_ascend=True, **kwargs):
    """Reference ``sort``: a sorted copy along ``axis`` (descending is the
    ascending sort reversed)."""
    def f(a):
        s = torch.sort(a, dim=axis, stable=True).values
        return s if is_ascend else torch.flip(s, (axis,))

    return apply_op(f, data, name="sort")


_export(sort)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype=np.float32, **kwargs):
    """Reference ``topk``: the ``k`` largest (or smallest) along
    ``axis``, ties taken in index order; ``ret_typ`` "value", "indices",
    "both" or "mask"."""
    if ret_typ not in ("value", "indices", "both", "mask"):
        raise MXNetError(f"unknown ret_typ {ret_typ}")
    dt = resolve_dtype(dtype)

    def f(a):
        am = torch.movedim(a, axis, -1)
        idx = torch.argsort(am if is_ascend else -am, dim=-1,
                            stable=True)[..., :k]
        vals = torch.gather(am, -1, idx)
        vals, idx_m = torch.movedim(vals, -1, axis), torch.movedim(idx, -1,
                                                                   axis)
        if ret_typ == "value":
            return vals
        if ret_typ == "indices":
            return idx_m.to(dt).detach()
        if ret_typ == "both":
            return vals, idx_m.to(dt).detach()
        mask = torch.zeros_like(am).scatter(-1, idx, 1.0)
        return torch.movedim(mask, -1, axis).detach()

    return apply_op(f, data, name="topk")


_export(topk)


def cumsum(data, axis=None, dtype=None, **kwargs):
    """Reference ``np.cumsum``: running sum along ``axis`` (of the
    flattened array when None)."""
    dt = resolve_dtype(dtype)

    def f(a):
        return torch.cumsum(a.reshape(-1) if axis is None else a,
                            dim=0 if axis is None else axis, dtype=dt)

    return apply_op(f, data, name="cumsum")


_export(cumsum)


# --- indexing ---------------------------------------------------------------

def take(a, indices, axis=0, mode="clip", **kwargs):
    """Reference ``take``: slices along ``axis`` gathered by an index
    array (``mode`` "clip" or "wrap")."""
    def f(arr, idx):
        ax = axis % arr.ndim
        n = arr.shape[ax]
        ii = idx.long()
        ii = torch.remainder(ii, n) if mode == "wrap" else ii.clamp(0, n - 1)
        out = arr.index_select(ax, ii.reshape(-1))
        return out.reshape(arr.shape[:ax] + tuple(ii.shape) +
                           arr.shape[ax + 1:])

    return apply_op(f, a, indices, name="take")


_export(take)


def pick(data, index, axis=-1, keepdims=False, mode="clip", **kwargs):
    """Reference ``pick``: one element per row along ``axis`` by an index
    array (clipped into range)."""
    def f(a, idx):
        ii = idx.long().clamp(0, a.shape[axis] - 1).unsqueeze(axis)
        out = torch.gather(a, axis, ii)
        return out if keepdims else out.squeeze(axis)

    return apply_op(f, data, index, name="pick")


_export(pick)


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype=np.float32,
            **kwargs):
    """Reference ``one_hot``: integer indices as one-hot rows of
    ``depth`` (an index out of range gives a row of ``off_value``)."""
    dt = resolve_dtype(dtype)

    def f(idx):
        oh = (idx.long().unsqueeze(-1) ==
              torch.arange(depth, device=idx.device)).to(dt)
        return oh * (on_value - off_value) + off_value

    return apply_op(f, indices, name="one_hot", no_grad=True)


_export(one_hot, no_grad=True)


def gather_nd(data, indices, **kwargs):
    """Reference ``gather_nd``: ``indices`` (M, ...) index the first M
    axes of ``data``."""
    def f(a, idx):
        idx = idx.long()
        return a[tuple(idx[i] for i in range(idx.shape[0]))]

    return apply_op(f, data, indices, name="gather_nd")


_export(gather_nd)


def scatter_nd(data, indices, shape, **kwargs):
    """Reference ``scatter_nd``: ``data`` summed into a zero array of
    ``shape`` at ``indices`` (M, ...)."""
    tgt = tuple(shape)

    def f(vals, idx):
        idx = idx.long()
        z = torch.zeros(tgt, dtype=vals.dtype, device=vals.device)
        return z.index_put(tuple(idx[i] for i in range(idx.shape[0])), vals,
                           accumulate=True)

    return apply_op(f, data, indices, name="scatter_nd")


_export(scatter_nd)


def boolean_mask(data, index, axis=0, **kwargs):
    """Reference ``boolean_mask``: the slices along ``axis`` where
    ``index`` is nonzero (the output's shape depends on the data: the
    mask is read on the host)."""
    keep = torch.nonzero(index._data.detach().cpu() != 0).reshape(-1)

    def f(a):
        return a.index_select(axis, keep.to(a.device))

    return apply_op(f, data, name="boolean_mask")


_export(boolean_mask)


def shape_array(data, **kwargs):
    """Reference ``shape_array``: the shape as a 1-D int64 array."""
    from ..ndarray.ndarray import NDArray

    return NDArray(torch.tensor(data.shape, dtype=torch.int64,
                                device=data._data.device))


def size_array(data, **kwargs):
    """Reference ``size_array``: the element count as a (1,) int64
    array."""
    from ..ndarray.ndarray import NDArray

    return NDArray(torch.tensor([data.size], dtype=torch.int64,
                                device=data._data.device))


_export(shape_array, no_grad=True)
_export(size_array, no_grad=True)


# --- sequence ops -------------------------------------------------------------

def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kwargs):
    """Reference ``SequenceMask``: steps past each sequence's length set
    to ``value`` (time on ``axis`` 0 or 1, batch on the other)."""
    if not use_sequence_length or sequence_length is None:
        return data

    def f(a, sl):
        pos = torch.arange(a.shape[axis], device=a.device)
        pos = pos.reshape((-1, 1) if axis == 0 else (1, -1))
        mask = pos < sl.reshape((1, -1) if axis == 0 else (-1, 1))
        mask = mask.reshape(mask.shape + (1,) * (a.ndim - 2))
        return torch.where(mask, a, torch.full((), value, dtype=a.dtype,
                                               device=a.device))

    return apply_op(f, data, sequence_length, name="sequence_mask")


_export(sequence_mask, aliases=("SequenceMask",))


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kwargs):
    """Reference ``SequenceLast``: each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return apply_op(lambda a: a.select(axis, -1), data,
                        name="sequence_last")

    def f(a, sl):
        am = torch.movedim(a, axis, 0)
        idx = (sl.long() - 1).reshape((1, -1) + (1,) * (am.ndim - 2))
        return torch.gather(am, 0, idx.expand((1,) + am.shape[1:]))[0]

    return apply_op(f, data, sequence_length, name="sequence_last")


_export(sequence_last, aliases=("SequenceLast",))


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **kwargs):
    """Reference ``SequenceReverse``: each sequence reversed up to its
    length, the padding left in place."""
    if not use_sequence_length or sequence_length is None:
        return flip(data, axis=axis)

    def f(a, sl):
        am = torch.movedim(a, axis, 0)
        pos = torch.arange(am.shape[0], device=a.device).reshape((-1, 1))
        slb = sl.long().reshape((1, -1))
        rev = torch.where(pos < slb, slb - 1 - pos, pos)
        rev = rev.reshape(rev.shape + (1,) * (am.ndim - 2)).expand(am.shape)
        return torch.movedim(torch.gather(am, 0, rev), 0, axis)

    return apply_op(f, data, sequence_length, name="sequence_reverse")


_export(sequence_reverse, aliases=("SequenceReverse",))


# --- matmul family ----------------------------------------------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    """Reference ``dot``: the last axis of ``lhs`` contracted with the
    first of ``rhs`` (after the optional transposes, which reverse all
    axes); bf16/f16 through ``mxu_matmul_nt``.  A sparse operand takes
    ``ndarray/sparse.dot``."""
    from ..ndarray import sparse as _sparse
    from .nn_ops import mxu_matmul_nt

    if isinstance(lhs, _sparse.BaseSparseNDArray) or \
            isinstance(rhs, _sparse.BaseSparseNDArray):
        return _sparse.dot(lhs, rhs, transpose_a=transpose_a,
                           transpose_b=transpose_b)

    def f(a, b):
        if transpose_a:
            a = a.permute(*reversed(range(a.ndim)))
        if transpose_b:
            b = b.permute(*reversed(range(b.ndim)))
        if a.dtype in _LOW:
            return mxu_matmul_nt(a.reshape(-1, a.shape[-1]),
                                 b.reshape(b.shape[0], -1)).reshape(
                                     a.shape[:-1] + b.shape[1:])
        return torch.tensordot(a, b, dims=1)

    return apply_op(f, lhs, rhs, name="dot")


_export(dot)


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    """Reference ``batch_dot``: (B..., M, K) x (B..., K, N); bf16/f16
    through ``mxu_batch_matmul``."""
    from .nn_ops import mxu_batch_matmul

    def f(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return mxu_batch_matmul(a, b) if a.dtype in _LOW else \
            torch.matmul(a, b)

    return apply_op(f, lhs, rhs, name="batch_dot")


_export(batch_dot)


def _t(a):
    return a.transpose(-1, -2)


def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 **kwargs):
    """Reference ``linalg_gemm2``: ``alpha·op(A)·op(B)``."""
    def f(a, b):
        return alpha * torch.matmul(_t(a) if transpose_a else a,
                                    _t(b) if transpose_b else b)

    return apply_op(f, A, B, name="linalg_gemm2")


def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2, **kwargs):
    """Reference ``linalg_gemm``: ``alpha·op(A)·op(B) + beta·C``, the
    matrix rows on ``axis``."""
    def f(a, b, c):
        if axis != -2:
            a, b, c = (torch.movedim(t, axis, -2) for t in (a, b, c))
        out = alpha * torch.matmul(_t(a) if transpose_a else a,
                                   _t(b) if transpose_b else b) + beta * c
        return torch.movedim(out, -2, axis) if axis != -2 else out

    return apply_op(f, A, B, C, name="linalg_gemm")


def linalg_potrf(A, **kwargs):
    """Reference ``linalg_potrf``: the lower Cholesky factor."""
    return apply_op(torch.linalg.cholesky, A, name="linalg_potrf")


def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kwargs):
    """Reference ``linalg_trsm``: X with ``op(A)·X = alpha·B`` (left) or
    ``X·op(A) = alpha·B`` (right), A triangular."""
    def f(a, b):
        tri = _t(a) if transpose else a
        upper = lower == transpose
        return alpha * torch.linalg.solve_triangular(tri, b, upper=upper,
                                                     left=not rightside)

    return apply_op(f, A, B, name="linalg_trsm")


def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kwargs):
    """Reference ``linalg_trmm``: ``alpha·op(tri(A))·B`` (or ``B·op``),
    the other triangle of A ignored."""
    def f(a, b):
        tri = torch.tril(a) if lower else torch.triu(a)
        if transpose:
            tri = _t(tri)
        return alpha * (torch.matmul(b, tri) if rightside else
                        torch.matmul(tri, b))

    return apply_op(f, A, B, name="linalg_trmm")


def linalg_potri(A, **kwargs):
    """Reference ``linalg_potri``: A⁻¹ from its Cholesky factor L."""
    def f(a):
        eye = torch.eye(a.shape[-1], dtype=a.dtype,
                        device=a.device).expand(a.shape)
        linv = torch.linalg.solve_triangular(a, eye, upper=False)
        return torch.matmul(_t(linv), linv)

    return apply_op(f, A, name="linalg_potri")


def linalg_sumlogdiag(A, **kwargs):
    """Reference ``linalg_sumlogdiag``: Σ log diag(A) per matrix."""
    return apply_op(lambda a: torch.log(torch.diagonal(
        a, dim1=-2, dim2=-1)).sum(-1), A, name="linalg_sumlogdiag")


def linalg_extractdiag(A, offset=0, **kwargs):
    """Reference ``linalg_extractdiag``: the ``offset`` diagonal."""
    return apply_op(lambda a: torch.diagonal(a, offset, -2, -1), A,
                    name="linalg_extractdiag")


def linalg_makediag(A, offset=0, **kwargs):
    """Reference ``linalg_makediag``: a vector as the ``offset``
    diagonal of a square matrix."""
    return apply_op(lambda a: torch.diag_embed(a, offset), A,
                    name="linalg_makediag")


def _trian_indices(n, offset, lower):
    """offset > 0: the upper band from that superdiagonal; offset < 0:
    the lower band; 0: the triangle ``lower`` names."""
    if offset > 0:
        return np.triu_indices(n, offset)
    if offset < 0:
        return np.tril_indices(n, offset)
    return np.tril_indices(n) if lower else np.triu_indices(n)


def linalg_extracttrian(A, offset=0, lower=True, **kwargs):
    """Reference ``linalg_extracttrian``: a triangle packed row by row
    into a vector."""
    def f(a):
        r, c = _trian_indices(a.shape[-1], offset, lower)
        return a[..., torch.from_numpy(r).to(a.device),
                 torch.from_numpy(c).to(a.device)]

    return apply_op(f, A, name="linalg_extracttrian")


def linalg_maketrian(A, offset=0, lower=True, **kwargs):
    """Reference ``linalg_maketrian``: the inverse of
    ``linalg_extracttrian``."""
    def f(a):
        m = a.shape[-1]
        n = int(round((np.sqrt(8 * m + 1) - 1) / 2)) + abs(offset)
        r, c = _trian_indices(n, offset, lower)
        if len(r) != m:
            raise MXNetError(f"maketrian: vector length {m} does not pack "
                             f"an offset-{offset} triangle")
        out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype,
                          device=a.device)
        out[..., torch.from_numpy(r).to(a.device),
            torch.from_numpy(c).to(a.device)] = a
        return out

    return apply_op(f, A, name="linalg_maketrian")


def linalg_gelqf(A, **kwargs):
    """Reference ``linalg_gelqf``: (L, Q) with A = L·Q and Q's rows
    orthonormal, from the QR of Aᵀ."""
    def f(a):
        q, r = torch.linalg.qr(_t(a), mode="reduced")
        return _t(r), _t(q)

    return apply_op(f, A, name="linalg_gelqf")


def linalg_syevd(A, **kwargs):
    """Reference ``linalg_syevd``: (U, Λ) with A = Uᵀ·diag(Λ)·U, U's rows
    the eigenvectors, Λ ascending."""
    def f(a):
        w, v = torch.linalg.eigh(a)
        return _t(v), w

    return apply_op(f, A, name="linalg_syevd")


def linalg_gesvd(A, **kwargs):
    """Reference ``linalg_gesvd``: (UT, L, V) with A = UT·diag(L)·V."""
    return apply_op(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=False)), A, name="linalg_gesvd")


def linalg_inverse(A, **kwargs):
    return apply_op(torch.linalg.inv, A, name="linalg_inverse")


def linalg_det(A, **kwargs):
    return apply_op(torch.linalg.det, A, name="linalg_det")


def linalg_slogdet(A, **kwargs):
    """Reference ``linalg_slogdet``: (sign, log|det|), batched."""
    return apply_op(lambda a: tuple(torch.linalg.slogdet(a)), A,
                    name="linalg_slogdet")


def linalg_syrk(A, transpose=False, alpha=1.0, **kwargs):
    """Reference ``linalg_syrk``: ``alpha·A·Aᵀ`` (``alpha·Aᵀ·A`` with
    ``transpose``)."""
    return apply_op(lambda a: alpha * (torch.matmul(_t(a), a) if transpose
                                       else torch.matmul(a, _t(a))),
                    A, name="linalg_syrk")


for _fn in (linalg_gemm2, linalg_potrf, linalg_trsm, linalg_gemm,
            linalg_trmm, linalg_potri, linalg_sumlogdiag, linalg_extractdiag,
            linalg_makediag, linalg_extracttrian, linalg_maketrian,
            linalg_gelqf, linalg_syevd, linalg_gesvd, linalg_syrk):
    _export(_fn)
_export(linalg_inverse, aliases=("inverse",))
_export(linalg_det, aliases=("det",))
_export(linalg_slogdet, aliases=("slogdet",))


def smooth_l1(data, scalar=1.0, **kwargs):
    """Reference ``smooth_l1``: quadratic inside ``1/scalar²``, linear
    outside."""
    s2 = float(scalar) ** 2

    def f(a):
        aa = torch.abs(a)
        return torch.where(aa < 1.0 / s2, 0.5 * s2 * torch.square(a),
                           aa - 0.5 / s2)

    return apply_op(f, data, name="smooth_l1")


_export(smooth_l1)

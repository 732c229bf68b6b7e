"""``mx.np`` — the NumPy-compatible front end.

Counterpart of ``mxnet_tpu/numpy/__init__.py`` (reference
``python/mxnet/numpy/``): a numpy-semantics ``ndarray`` type and a
namespace of functions over the same op dispatch as ``mx.nd``, gated by
``mx.util.set_np()`` as in the reference.  The reference binds jnp
functions, which are numpy's semantics; here each name is a torch
function written to numpy's semantics where torch's differ (``_IMPL``),
bound through ``ops.registry.apply_op`` (autograd, amp and the profiler
apply).  The differences held to numpy:

- ``median`` averages the two middle values and ``percentile``/
  ``quantile`` interpolate linearly (``torch.median`` returns the lower
  middle; ``torch.quantile`` refuses more than 2^24 elements), through
  one stable sort;
- ``mod``/``remainder`` take the divisor's sign (``torch.remainder``, not
  ``torch.fmod``) and ``floor_divide`` floors;
- ``nonzero`` returns a tuple; ``unique`` sorts; ``sort``/``argsort`` are
  stable (as ``jnp.argsort`` is); ``round`` rounds half to even;
  ``std``/``var`` take ``ddof``;
- ``argmax``/``argmin`` return the first NaN where there is one;
- ``histogram``, ``interp``, ``trapz`` and ``digitize`` use numpy's edge
  rules (the last bin closed, ``left``/``right`` fills, ``right=``);
- comparisons and predicates return bool arrays;
- creation defaults to float32 (the reference's classic default), or
  float64 under ``mx.util.set_np_default_dtype()``; integer payloads
  stay int64.

Dtypes are ``torch.dtype`` objects, as everywhere in the port:
``mx.np.float32`` is ``torch.float32``.  An op on an ``mx.np.ndarray``
returns an ``mx.np.ndarray`` (the operators, indexing and every function
here); the classic ``NDArray`` methods (``.sum()``, ``.reshape()``) return
the classic type, as in the reference.
"""
from __future__ import annotations

import builtins as _builtins
import math as _math

import numpy as _onp
import torch as _torch

from ..base import MXNetError, resolve_dtype as _resolve_dtype
from ..context import current_context
from ..ndarray import NDArray
from ..ops.registry import apply_op as _apply_op

__all__ = ["ndarray"]

float32 = _torch.float32
float64 = _torch.float64
float16 = _torch.float16
bfloat16 = _torch.bfloat16
int8 = _torch.int8
int32 = _torch.int32
int64 = _torch.int64
uint8 = _torch.uint8
bool_ = _torch.bool
pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None


class ndarray(NDArray):
    """NumPy-semantics array (reference ``mxnet.numpy.ndarray``): the
    NDArray machinery with a numpy repr; operators, comparisons and
    indexing stay in the np type."""

    __slots__ = ()

    def __repr__(self):
        arr = self.asnumpy()
        return f"array({_onp.array2string(arr, separator=', ')})" \
            if arr.ndim else f"array({arr.item()})"

    def _binary(self, other, fn, name, reflected=False):
        return _np(super()._binary(other, fn, name, reflected=reflected))

    def _cmp(self, o, name):
        out = super()._cmp(o, name)
        return out if out is NotImplemented else _np(out)

    def __neg__(self):
        return _np(super().__neg__())

    def __abs__(self):
        return _np(super().__abs__())

    def __getitem__(self, key):
        return _np(super().__getitem__(key))

    def as_nd_ndarray(self):
        """The classic ``mx.nd`` type over the same tensor (reference
        ``ndarray.as_nd_ndarray``)."""
        out = NDArray.__new__(NDArray)
        _share(self, out)
        return out

    def as_np_ndarray(self):
        return self

    def item(self):
        return self.asnumpy().item()

    def tolist(self):
        return self.asnumpy().tolist()

    @property
    def device(self):
        return self.context


def _share(src, dst):
    dst._raw = src._raw
    dst._grad = src._grad
    dst._grad_req = src._grad_req


def _np(x):
    """``x`` typed as ``mx.np.ndarray`` (a new handle over the same
    tensor and gradient); tuples and lists element by element."""
    if isinstance(x, ndarray):
        return x
    if type(x) is NDArray:
        out = ndarray.__new__(ndarray)
        _share(x, out)
        return out
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def _wrap(fn, name, no_grad=False):
    """Bind tensor function ``fn`` into the op dispatch as ``np_<name>``.

    NDArray positionals (and NDArrays one level inside a list or tuple
    positional, for ``concatenate``/``stack``/``einsum``) and NDArray
    keyword values are the op's operands; everything else (scalars,
    shapes, lists of numbers) closes over the function, as in the
    reference."""
    opname = f"np_{name}"

    def call(*args, **kwargs):
        paths, tracked = [], []
        for i, a in enumerate(args):
            if isinstance(a, NDArray):
                paths.append((i, None))
                tracked.append(a)
            elif isinstance(a, (list, tuple)):
                for j, el in enumerate(a):
                    if isinstance(el, NDArray):
                        paths.append((i, j))
                        tracked.append(el)
        kw_arr = [k for k, v in kwargs.items() if isinstance(v, NDArray)]
        tracked += [kwargs[k] for k in kw_arr]

        def pure(*raws):
            full = [list(a) if isinstance(a, (list, tuple)) else a
                    for a in args]
            for (i, j), r in zip(paths, raws):
                if j is None:
                    full[i] = r
                else:
                    full[i][j] = r
            kw = dict(kwargs)
            for k, r in zip(kw_arr, raws[len(paths):]):
                kw[k] = r
            return fn(*full, **kw)

        if not tracked:  # no array operand: compute on the current device
            with _torch.device(current_context().device):
                out = fn(*args, **kwargs)
            return _np(_wrap_raw(out))
        return _np(_apply_op(pure, *tracked, name=opname,
                              no_grad=no_grad))

    call.__name__ = call.__qualname__ = name
    call.__doc__ = f"mx.np.{name}: numpy's semantics (see numpy.{name})."
    return call


def _wrap_raw(out):
    if isinstance(out, (tuple, list)):
        return tuple(_wrap_raw(o) for o in out)
    return NDArray(out) if isinstance(out, _torch.Tensor) else out


# --- dtype and operand helpers -------------------------------------------

def _float_default():
    from .. import util as _util

    return _torch.float64 if _util.is_np_default_dtype() else _torch.float32


def _t(x, like=None):
    """``x`` as a tensor on ``like``'s device: a Python scalar takes the
    dtype torch's promotion gives it beside ``like`` (numpy's weak
    scalars), a list or numpy array numpy's dtype, float64 read as the
    float default (float32 unless ``set_np_default_dtype``)."""
    if isinstance(x, _torch.Tensor):
        return x
    if isinstance(x, NDArray):
        return x._data
    dev = like.device if isinstance(like, _torch.Tensor) else None
    if isinstance(x, (bool, int, float, complex, _onp.generic)) and \
            _onp.ndim(x) == 0 and isinstance(like, _torch.Tensor):
        return _torch.tensor(x.item() if isinstance(x, _onp.generic) else x,
                             dtype=_torch.result_type(like, x), device=dev)
    arr = _onp.asarray(x)
    t = _torch.as_tensor(arr, device=dev)
    if arr.dtype == _onp.float64:
        t = t.to(_float_default())
    return t


def _pair(a, b):
    if isinstance(a, _torch.Tensor):
        return a, _t(b, a)
    b = _t(b)
    return _t(a, b), b


def _binary(f):
    def g(a, b, *args, **kwargs):
        a, b = _pair(a, b)
        return f(a, b, *args, **kwargs)

    return g


def _fl(x):
    """A float tensor (integers and bools as the float default)."""
    x = _t(x)
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(_float_default())


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        return (axis % ndim if ndim else 0,)
    return tuple(a % ndim for a in axis)


def _reduce_dims(x, axis):
    """torch's ``dim`` for numpy's ``axis`` (None: every axis)."""
    return tuple(range(x.ndim)) if axis is None else \
        (axis if isinstance(axis, int) else tuple(axis))


# --- implementations ---------------------------------------------------------

def _cbrt(x):
    x = _fl(x)
    return _torch.sign(x) * _torch.abs(x).pow(1.0 / 3.0)


def _real(x):
    return _torch.real(x) if x.is_complex() else x


def _imag(x):
    return _torch.imag(x) if x.is_complex() else _torch.zeros_like(x)


def _angle(x, deg=False):
    a = _torch.angle(_fl(x))
    return _torch.rad2deg(a) if deg else a


def _sort(a, axis=-1, kind=None, order=None, stable=None):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return _torch.sort(a, dim=axis, stable=True).values


def _argsort(a, axis=-1, kind=None, order=None, stable=None):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return _torch.argsort(a, dim=axis, stable=True)


def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, equal_nan=True):
    flat = ar.reshape(-1) if axis is None else ar
    vals, inv, counts = _torch.unique(flat, sorted=True, return_inverse=True,
                                      return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = flat.shape[0 if axis is None else axis]
        pos = _torch.arange(n, device=ar.device)
        first = _torch.full((vals.shape[0 if axis is None else axis],), n,
                            dtype=_torch.int64, device=ar.device)
        out.append(first.scatter_reduce(0, inv.reshape(-1), pos, "amin"))
    if return_inverse:
        out.append(inv.reshape(ar.shape) if axis is None else inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def _nonzero(a):
    return tuple(_torch.nonzero(a, as_tuple=True))


def _flatnonzero(a):
    return _torch.nonzero(a.reshape(-1)).reshape(-1)


def _diagonal(a, offset=0, axis1=0, axis2=1):
    return _torch.diagonal(a, offset, axis1, axis2)


def _atleast(f):
    def g(*arys):
        out = [f(_t(a)) for a in arys]
        return out[0] if len(out) == 1 else out

    return g


def _copy(a, order="K"):
    return a.clone()


def _divide(a, b):
    return _torch.true_divide(_fl(a) if not b.is_floating_point() else a, b)


def _ldexp(x1, x2):
    return _torch.ldexp(_fl(x1), x2)


def _heaviside(x1, x2):
    x2 = x2.to(x1.dtype) if x1.dtype != x2.dtype else x2
    return _torch.heaviside(x1, x2)


def _nextafter(x1, x2):
    dt = _torch.promote_types(x1.dtype, x2.dtype)
    return _torch.nextafter(x1.to(dt), x2.to(dt))


def _dot(a, b):
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return _torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return _torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def _vdot(a, b):
    return (_torch.conj_physical(a).reshape(-1) * b.reshape(-1)).sum()


def _outer(a, b):
    return _torch.outer(a.reshape(-1), b.reshape(-1))


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis
    a = _torch.movedim(a, axisa, -1)
    b = _torch.movedim(b, axisb, -1)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    if a.shape[-1] == 2:
        a = _torch.nn.functional.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = _torch.nn.functional.pad(b, (0, 1))
    a, b = _torch.broadcast_tensors(a, b)
    return _torch.movedim(_torch.linalg.cross(a, b, dim=-1), -1, axisc)


def _convolve(a, v, mode="full"):
    a, v = _fl(a), _fl(v)
    dt = _torch.promote_types(a.dtype, v.dtype)
    a, v = a.to(dt), v.to(dt)
    if v.shape[0] > a.shape[0]:
        a, v = v, a
    n, m = a.shape[0], v.shape[0]
    full = _torch.nn.functional.conv1d(
        a.reshape(1, 1, n), v.flip(0).reshape(1, 1, m),
        padding=m - 1).reshape(-1)
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    if mode == "valid":
        return full[m - 1:n]
    raise MXNetError(f"convolve: unknown mode {mode!r}")


def _correlate(a, v, mode="valid"):
    if v.shape[0] > a.shape[0]:  # numpy swaps, then reverses
        return _torch.conj_physical(_correlate(v, a, mode)).flip(0)
    return _convolve(a, _torch.conj_physical(v).flip(0), mode)


def _searchsorted(a, v, side="left", sorter=None):
    if sorter is not None:
        a = a[_t(sorter, a).long()]
    v = _t(v, a)
    scalar = v.ndim == 0
    out = _torch.searchsorted(a, v.reshape(-1) if scalar else v.contiguous(),
                              right=side == "right")
    return out.reshape(()) if scalar else out


# reductions

def _sum(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None):
    r = _torch.sum(a, dim=_reduce_dims(a, axis), keepdim=keepdims,
                   dtype=_resolve_dtype(dtype))
    return r + initial if initial is not None else r


def _mean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):
    dt = _resolve_dtype(dtype)
    a = a.to(dt) if dt is not None else _fl(a)
    return _torch.mean(a, dim=_reduce_dims(a, axis), keepdim=keepdims)


def _amax(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    r = _torch.amax(a, dim=_reduce_dims(a, axis), keepdim=keepdims)
    return _torch.clamp(r, min=initial) if initial is not None else r


def _amin(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    r = _torch.amin(a, dim=_reduce_dims(a, axis), keepdim=keepdims)
    return _torch.clamp(r, max=initial) if initial is not None else r


def _prod(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
          where=None):
    dt = _resolve_dtype(dtype)
    if dt is None and not (a.is_floating_point() or a.is_complex()):
        dt = _torch.int64
    r = a.to(dt) if dt is not None else a
    for ax in sorted(_axes(axis, a.ndim), reverse=True):
        r = _torch.prod(r, dim=ax, keepdim=keepdims)
    if axis is None and a.ndim == 0:
        r = r.clone()
    return r * initial if initial is not None else r


def _nanprod(a, axis=None, dtype=None, out=None, keepdims=False):
    return _prod(_torch.where(_torch.isnan(a), _torch.ones_like(a), a)
                 if a.is_floating_point() else a, axis, dtype,
                 keepdims=keepdims)


def _nansum(a, axis=None, dtype=None, out=None, keepdims=False):
    if not a.is_floating_point():
        return _sum(a, axis, dtype, keepdims=keepdims)
    return _torch.nansum(a, dim=_reduce_dims(a, axis), keepdim=keepdims,
                         dtype=_resolve_dtype(dtype))


def _var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         where=None, mean=None, correction=None):
    a = _fl(a)
    corr = ddof if correction is None else correction
    return _torch.var(a, dim=_reduce_dims(a, axis), correction=corr,
                      keepdim=keepdims)


def _std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         where=None, mean=None, correction=None):
    return _torch.sqrt(_var(a, axis, dtype, out, ddof, keepdims,
                            correction=correction))


def _quantile_core(a, q, axis, keepdims):
    """numpy's ``method="linear"`` quantile: virtual index q·(n−1) into
    the stably sorted values, interpolated between its neighbours (numpy's
    ``_lerp``); q's axes lead the result."""
    a = _fl(a)
    q = _t(q, a).to(a.dtype)
    if axis is None:
        src, axes = a.reshape(-1), (0,)
        moved = src
    else:
        axes = _axes(axis, a.ndim)
        rest = [d for d in range(a.ndim) if d not in axes]
        moved = a.permute(*rest, *axes).reshape(
            *[a.shape[d] for d in rest], -1)
    n = moved.shape[-1]
    s = _torch.sort(moved, dim=-1, stable=True).values
    vi = q.reshape(-1) * (n - 1)
    lo = _torch.floor(vi).long().clamp(0, n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    t = vi - lo.to(vi.dtype)
    x0 = s[..., lo]
    x1 = s[..., hi]
    diff = x1 - x0
    r = _torch.where(t >= 0.5, x1 - diff * (1 - t), x0 + diff * t)
    # NaN anywhere in a slice makes its quantile NaN (numpy)
    has_nan = _torch.isnan(moved).any(dim=-1, keepdim=True)
    r = _torch.where(has_nan, _torch.full_like(r, float("nan")), r)
    r = _torch.movedim(r, -1, 0).reshape(tuple(q.shape) + r.shape[:-1])
    if keepdims:
        shape = list(a.shape)
        for d in (range(a.ndim) if axis is None else axes):
            shape[d] = 1
        r = r.reshape(tuple(q.shape) + tuple(shape))
    return r


def _quantile(a, q, axis=None, out=None, overwrite_input=False,
              method="linear", keepdims=False, **kw):
    if method != "linear":
        raise MXNetError(f"quantile: method {method!r} is not supported "
                         "(linear only, the reference's default)")
    return _quantile_core(a, q, axis, keepdims)


def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, **kw):
    q = _t(q, _fl(a)) / 100.0
    return _quantile(a, q, axis, method=method, keepdims=keepdims)


def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile_core(a, 0.5, axis, keepdims)


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _fl(a)
    if weights is None:
        avg = _torch.mean(a, dim=_reduce_dims(a, axis), keepdim=keepdims)
        cnt = _torch.full_like(avg, a.numel() / max(avg.numel(), 1))
    else:
        w = _t(weights, a).to(a.dtype)
        if w.shape != a.shape:
            if axis is None or w.ndim != 1:
                raise MXNetError("average: weights differ from a in shape; "
                                 "give 1-d weights and an axis")
            shape = [1] * a.ndim
            shape[axis] = -1
            w = w.reshape(shape)
        w = _torch.broadcast_to(w, a.shape)
        dims = _reduce_dims(a, axis)
        cnt = w.sum(dim=dims, keepdim=keepdims)
        avg = (a * w).sum(dim=dims, keepdim=keepdims) / cnt
    return (avg, cnt) if returned else avg


def _ptp(a, axis=None, out=None, keepdims=False):
    return _amax(a, axis, keepdims=keepdims) - _amin(a, axis,
                                                     keepdims=keepdims)


def _arg_nanfirst(f):
    def g(a, axis=None, out=None, keepdims=False):
        flat = axis is None
        x = a.reshape(-1) if flat else a
        dim = 0 if flat else axis
        r = f(x, dim=dim, keepdim=keepdims and not flat)
        if x.is_floating_point():
            nan = _torch.isnan(x)
            first = _torch.argmax(nan.to(_torch.uint8), dim=dim,
                                  keepdim=keepdims and not flat)
            any_nan = nan.any(dim=dim, keepdim=keepdims and not flat)
            r = _torch.where(any_nan, first, r)
        if flat and keepdims:
            r = r.reshape((1,) * a.ndim)
        return r

    return g


def _nanarg(f, fill):
    def g(a, axis=None, out=None, keepdims=False):
        if a.is_floating_point():
            a = _torch.where(_torch.isnan(a),
                             _torch.full_like(a, fill), a)
        return _arg_nanfirst(f)(a, axis, keepdims=keepdims)

    return g


def _all(a, axis=None, out=None, keepdims=False, where=None):
    return _torch.all(a.bool(), dim=_reduce_dims(a, axis), keepdim=keepdims)


def _any(a, axis=None, out=None, keepdims=False, where=None):
    return _torch.any(a.bool(), dim=_reduce_dims(a, axis), keepdim=keepdims)


def _cum(f, nan_fill=None):
    def g(a, axis=None, dtype=None, out=None):
        if nan_fill is not None and a.is_floating_point():
            a = _torch.where(_torch.isnan(a),
                             _torch.full_like(a, nan_fill), a)
        if axis is None:
            a, axis = a.reshape(-1), 0
        return f(a, dim=axis, dtype=_resolve_dtype(dtype))

    return g


def _count_nonzero(a, axis=None, keepdims=False):
    r = _torch.count_nonzero(a, dim=_reduce_dims(a, axis))
    if keepdims:
        shape = list(a.shape)
        for d in _axes(axis, a.ndim):
            shape[d] = 1
        r = r.reshape(shape)
    return r


# shapes

def _reshape(a, newshape=None, order="C", shape=None, copy=None):
    s = shape if shape is not None else newshape
    return _torch.reshape(a, (s,) if isinstance(s, int) else tuple(s))


def _transpose(a, axes=None):
    return a.permute(*(reversed(range(a.ndim)) if axes is None else axes))


def _rollaxis(a, axis, start=0):
    axis %= a.ndim
    start = start + a.ndim if start < 0 else start
    if axis < start:
        start -= 1
    return _torch.movedim(a, axis, start)


def _expand_dims(a, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    nd = a.ndim + len(axes)
    for ax in sorted(x % nd for x in axes):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    for ax in sorted(_axes(axis, a.ndim), reverse=True):
        if a.shape[ax] != 1:
            raise MXNetError("cannot select an axis to squeeze out which "
                             "has size not equal to one")
        a = a.squeeze(ax)
    return a


def _concatenate(arrays, axis=0, out=None, dtype=None):
    ts = [_t(x) for x in arrays]
    if axis is None:
        ts, axis = [x.reshape(-1) for x in ts], 0
    r = _torch.cat(ts, dim=axis)
    return r.to(_resolve_dtype(dtype)) if dtype is not None else r


def _stack(arrays, axis=0, out=None, dtype=None):
    r = _torch.stack([_t(x) for x in arrays], dim=axis)
    return r.to(_resolve_dtype(dtype)) if dtype is not None else r


def _seq(f):
    def g(tup, *args, **kwargs):
        return f([_t(x) for x in tup])

    return g


def _split(ary, indices_or_sections, axis=0):
    if isinstance(indices_or_sections, int) and \
            ary.shape[axis] % indices_or_sections:
        raise MXNetError("array split does not result in an equal division")
    return _array_split(ary, indices_or_sections, axis)


def _array_split(ary, indices_or_sections, axis=0):
    s = indices_or_sections
    return list(_torch.tensor_split(
        ary, s if isinstance(s, int) else list(s), dim=axis))


def _hsplit(ary, s):
    return _split(ary, s, 1 if ary.ndim > 1 else 0)


def _vsplit(ary, s):
    return _split(ary, s, 0)


def _dsplit(ary, s):
    return _split(ary, s, 2)


def _tile(a, reps):
    return _torch.tile(a, (reps,) if isinstance(reps, int) else tuple(reps))


def _repeat(a, repeats, axis=None):
    if not isinstance(repeats, int):
        repeats = _t(repeats, a).long()
    return _torch.repeat_interleave(a, repeats, dim=axis)


def _roll(a, shift, axis=None):
    if axis is None:
        return _torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return _torch.roll(a, shift, dims=axis)


def _flip(m, axis=None):
    return _torch.flip(m, dims=_axes(axis, m.ndim))


def _rot90(m, k=1, axes=(0, 1)):
    return _torch.rot90(m, k, dims=list(axes))


def _broadcast_to(array, shape):
    return _torch.broadcast_to(array, (shape,) if isinstance(shape, int)
                               else tuple(shape))


def _broadcast_arrays(*args):
    return list(_torch.broadcast_tensors(*[_t(a) for a in args]))


def _append(arr, values, axis=None):
    values = _t(values, arr)
    if axis is None:
        return _torch.cat([arr.reshape(-1), values.reshape(-1)])
    return _torch.cat([arr, values], dim=axis)


def _where(condition, x=None, y=None):
    if x is None and y is None:
        return _nonzero(condition)
    cond = _t(condition).bool()
    if isinstance(x, _torch.Tensor) or isinstance(y, _torch.Tensor):
        x, y = _pair(x, y)
    else:
        x, y = _pair(_t(x, cond.float()), y)
    return _torch.where(cond, x, y)


def _clip(a, a_min=None, a_max=None, out=None, min=None, max=None):
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    lo = _t(lo, a) if isinstance(lo, (list, _onp.ndarray)) else lo
    hi = _t(hi, a) if isinstance(hi, (list, _onp.ndarray)) else hi
    return _torch.clamp(a, min=lo, max=hi)


def _round(a, decimals=0, out=None):
    if a.is_floating_point():
        return _torch.round(a, decimals=decimals)
    if decimals >= 0:
        return a.clone()
    f = 10 ** (-decimals)
    return (_torch.round(a.double() / f) * f).to(a.dtype)


def _take(a, indices, axis=None, out=None, mode=None):
    idx = _t(indices, a).long() if not isinstance(indices, int) else \
        _torch.tensor(indices, device=a.device)
    src = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else axis % a.ndim
    n = src.shape[ax]
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:
        idx = idx % n
    out = _torch.index_select(src, ax, idx.reshape(-1))
    return out.reshape(*src.shape[:ax], *idx.shape, *src.shape[ax + 1:])


def _take_along_axis(arr, indices, axis):
    idx = _t(indices, arr).long()
    if axis is None:
        return arr.reshape(-1)[idx.reshape(-1)]
    return _torch.take_along_dim(arr, idx, dim=axis)


def _partition(a, kth, axis=-1, kind=None, order=None):
    return _sort(a, axis)


def _argpartition(a, kth, axis=-1, kind=None, order=None):
    return _argsort(a, axis)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    return _sum(_torch.diagonal(a, offset, axis1, axis2), -1, dtype)


def _tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return _torch.tensordot(a, b, dims=axes)


def _einsum(subscripts, *operands, optimize=None, **kwargs):
    return _torch.einsum(subscripts, *[_t(o) for o in operands])


def _pad_index(n, before, after, mode, device):
    """Source index of each position of an axis of length ``n`` padded by
    ``before`` and ``after`` (numpy's edge, reflect, symmetric and wrap
    rules)."""
    i = _torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return _torch.zeros_like(i)
        p = 2 * (n - 1)
        i = i % p
        return _torch.where(i >= n, p - i, i)
    if mode == "symmetric":
        p = 2 * n
        i = i % p
        return _torch.where(i >= n, p - 1 - i, i)
    raise MXNetError(f"pad: mode {mode!r} is not supported")


def _pad_widths(pad_width, ndim):
    pw = _onp.asarray(pad_width, dtype=_onp.int64)
    return _onp.broadcast_to(pw.reshape(-1, 2) if pw.ndim else pw,
                             (ndim, 2)).tolist() if pw.size != 2 or \
        pw.ndim != 1 else [list(pw)] * ndim


def _pad(array, pad_width, mode="constant", **kwargs):
    widths = _pad_widths(pad_width, array.ndim)
    if mode == "constant":
        cv = kwargs.get("constant_values", 0)
        cvs = _onp.broadcast_to(_onp.asarray(cv, dtype=_onp.float64),
                                (array.ndim, 2))
        out = array
        for ax in range(array.ndim):
            b, a_ = widths[ax]
            if not b and not a_:
                continue
            shape = list(out.shape)
            parts = []
            if b:
                shape[ax] = b
                parts.append(_torch.full(shape, float(cvs[ax][0]),
                                         dtype=out.dtype, device=out.device))
            parts.append(out)
            if a_:
                shape[ax] = a_
                parts.append(_torch.full(shape, float(cvs[ax][1]),
                                         dtype=out.dtype, device=out.device))
            out = _torch.cat(parts, dim=ax)
        return out
    out = array
    for ax in range(array.ndim):
        b, a_ = widths[ax]
        if b or a_:
            out = _torch.index_select(out, ax, _pad_index(
                out.shape[ax], b, a_, mode, out.device))
    return out


def _bincount(x, weights=None, minlength=0):
    w = None if weights is None else _t(weights, x)
    return _torch.bincount(x.reshape(-1), w, minlength=minlength)


def _digitize(x, bins, right=False):
    bins = _t(bins, _fl(x))
    x = _t(x, bins)
    increasing = bool(bins.numel() < 2 or (bins[-1] >= bins[0]).item())
    if increasing:
        return _torch.searchsorted(bins, x.contiguous(), right=not right)
    rb = bins.flip(0)
    return bins.numel() - _torch.searchsorted(rb, x.contiguous(),
                                              right=not right)


def _interp(x, xp, fp, left=None, right=None, period=None):
    x = _fl(x)
    xp, fp = _t(xp, x).to(x.dtype), _t(fp, x)
    fp = fp if fp.is_floating_point() or fp.is_complex() else \
        fp.to(x.dtype)
    if period is not None:
        period = _builtins.abs(float(period))
        x = _torch.remainder(x, period)
        xp = _torch.remainder(xp, period)
        order = _torch.argsort(xp, stable=True)
        xp, fp = xp[order], fp[order]
        xp = _torch.cat([xp[-1:] - period, xp, xp[:1] + period])
        fp = _torch.cat([fp[-1:], fp, fp[:1]])
    n = xp.shape[0]
    j = _torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = xp[j - 1], xp[j]
    y0, y1 = fp[j - 1], fp[j]
    slope = (y1 - y0) / (x1 - x0)
    r = slope * (x - x0) + y0
    # numpy: exact at an abscissa, fp[-1] at the last one
    r = _torch.where(x == x1, y1, r)
    lo = fp[0] if left is None else _torch.as_tensor(left, dtype=r.dtype,
                                                    device=r.device)
    hi = fp[-1] if right is None else _torch.as_tensor(right, dtype=r.dtype,
                                                      device=r.device)
    if period is None:
        r = _torch.where(x < xp[0], lo, r)
        r = _torch.where(x > xp[-1], hi, r)
        r = _torch.where(x == xp[-1], fp[-1], r)
    return r


def _hist_edges(a, bins, range):
    if isinstance(bins, int):
        if range is None:
            lo = a.min().item() if a.numel() else 0.0
            hi = a.max().item() if a.numel() else 1.0
        else:
            lo, hi = (float(v) for v in range)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        dt = a.dtype if a.is_floating_point() else _float_default()
        return _torch.linspace(lo, hi, bins + 1, dtype=_torch.float64,
                               device=a.device).to(dt)
    return _t(bins, _fl(a))


def _histogram(a, bins=10, range=None, density=None, weights=None):
    a = a.reshape(-1)
    edges = _hist_edges(a, bins, range)
    x = a.to(edges.dtype)
    nb = edges.numel() - 1
    idx = _torch.searchsorted(edges, x.contiguous(), right=True) - 1
    idx = _torch.where(x == edges[-1], _torch.full_like(idx, nb - 1), idx)
    keep = (x >= edges[0]) & (x <= edges[-1])
    w = None if weights is None else _t(weights, a).reshape(-1)
    if w is None:
        w = _torch.ones_like(x, dtype=_torch.int64)
    hist = _torch.zeros(nb, dtype=w.dtype, device=a.device)
    hist.index_add_(0, idx[keep], w[keep])
    if density:
        hist = hist.to(edges.dtype) / hist.sum() / _torch.diff(edges)
    return hist, edges


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _pair(a, b)
    dt = _torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        dt = _float_default()
    return _torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                          equal_nan=equal_nan)


def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _torch.all(_isclose(a, b, rtol, atol, equal_nan))


def _array_equal(a1, a2, equal_nan=False):
    a1, a2 = _pair(a1, a2)
    if a1.shape != a2.shape:
        return _torch.tensor(False, device=a1.device)
    eq = a1 == a2
    if equal_nan and a1.is_floating_point():
        eq = eq | (_torch.isnan(a1) & _torch.isnan(a2))
    return _torch.all(eq)


def _array_equiv(a1, a2):
    a1, a2 = _pair(a1, a2)
    try:
        x, y = _torch.broadcast_tensors(a1, a2)
    except RuntimeError:
        return _torch.tensor(False, device=a1.device)
    return _torch.all(x == y)


def _tri_fn(f):
    def g(m, k=0):
        return f(m, diagonal=k)

    return g


def _meshgrid(*xi, indexing="xy", sparse=False, copy=True):
    xs = [_t(x).reshape(-1) for x in xi]
    if sparse:  # each input along its own axis, 1 elsewhere
        out = []
        for i, x in enumerate(xs):
            shape = [1] * len(xs)
            swap = indexing == "xy" and len(xs) > 1 and i < 2
            shape[1 - i if swap else i] = -1
            out.append(x.reshape(shape))
        return out
    return [g.clone() for g in _torch.meshgrid(*xs, indexing=indexing)]


def _unravel_index(indices, shape, order="C"):
    idx = _t(indices).long()
    dims = list(shape)
    if order == "F":
        dims = dims[::-1]
    out = []
    for d in reversed(dims):
        out.append(idx % d)
        idx = _torch.div(idx, d, rounding_mode="floor")
    out = out[::-1]
    if order == "F":
        out = out[::-1]
    return tuple(out)


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_t(m).long() for m in multi_index]
    dims = list(dims)
    if order == "F":
        idx, dims = idx[::-1], dims[::-1]
    flat = _torch.zeros_like(idx[0])
    for i, d in zip(idx, dims):
        if mode == "wrap":
            i = i % d
        elif mode == "clip":
            i = i.clamp(0, d - 1)
        flat = flat * d + i
    return flat


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    pre = None if prepend is None else _diff_edge(a, prepend, axis)
    app = None if append is None else _diff_edge(a, append, axis)
    return _torch.diff(a, n=n, dim=axis, prepend=pre, append=app)


def _diff_edge(a, v, axis):
    v = _t(v, a)
    if v.ndim == 0:
        shape = list(a.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


def _ediff1d(ary, to_end=None, to_begin=None):
    d = _torch.diff(ary.reshape(-1))
    parts = []
    if to_begin is not None:
        parts.append(_t(to_begin, d).reshape(-1).to(d.dtype))
    parts.append(d)
    if to_end is not None:
        parts.append(_t(to_end, d).reshape(-1).to(d.dtype))
    return _torch.cat(parts) if len(parts) > 1 else d


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _fl(f)
    axes = _axes(axis, f.ndim)
    if not varargs:
        spacing = [1.0] * len(axes)
    elif len(varargs) == 1 and _onp.ndim(varargs[0]) == 0:
        spacing = [float(varargs[0])] * len(axes)
    else:
        spacing = [v if _onp.ndim(v) == 0 else _t(v, f) for v in varargs]
    out = []
    for ax, h in zip(axes, spacing):
        sp = (h,) if isinstance(h, _torch.Tensor) else h
        out.append(_torch.gradient(f, spacing=sp, dim=ax,
                                   edge_order=edge_order)[0])
    return out[0] if len(out) == 1 else out


def _trapz(y, x=None, dx=1.0, axis=-1):
    y = _fl(y)
    if x is None:
        return _torch.trapezoid(y, dx=dx, dim=axis)
    return _torch.trapezoid(y, _t(x, y).to(y.dtype), dim=axis)


def _host_index(obj):
    """An index argument on the host (a tensor of positions is read)."""
    return obj.tolist() if isinstance(obj, _torch.Tensor) else obj


def _insert(arr, obj, values, axis=None):
    obj = _host_index(obj)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.ndim
    n = arr.shape[axis]
    values = _t(values, arr).to(arr.dtype)
    if isinstance(obj, int) or _onp.ndim(obj) == 0:
        pos = int(obj) % (n + 1) if int(obj) < 0 else int(obj)
        vshape = list(arr.shape)
        vshape[axis] = 1 if values.ndim < arr.ndim else values.shape[axis]
        if values.ndim < arr.ndim:
            values = values.unsqueeze(axis) if values.ndim == arr.ndim - 1 \
                else values
        values = _torch.broadcast_to(values, vshape)
        return _torch.cat([arr.narrow(axis, 0, pos), values,
                           arr.narrow(axis, pos, n - pos)], dim=axis)
    pos = _onp.asarray(obj).reshape(-1)
    pos = _onp.where(pos < 0, pos + n, pos)
    k = len(pos)
    vshape = list(arr.shape)
    vshape[axis] = k
    if values.ndim == arr.ndim:
        values = _torch.broadcast_to(values, vshape)
    else:
        shape = [1] * arr.ndim
        shape[axis] = -1 if values.numel() == k else 1
        values = _torch.broadcast_to(values.reshape(shape), vshape)
    order = _onp.argsort(pos, kind="stable")
    new_pos = _onp.asarray(pos)[order] + _onp.arange(k)
    total = n + k
    is_new = _onp.zeros(total, bool)
    is_new[new_pos] = True
    src_old = _torch.as_tensor(_onp.flatnonzero(~is_new), device=arr.device)
    out_shape = list(arr.shape)
    out_shape[axis] = total
    out = _torch.empty(out_shape, dtype=arr.dtype, device=arr.device)
    out = out.index_copy(axis, src_old, arr)
    vals = values.index_select(axis, _torch.as_tensor(order,
                                                      device=arr.device))
    return out.index_copy(axis, _torch.as_tensor(new_pos,
                                                 device=arr.device), vals)


def _delete(arr, obj, axis=None):
    obj = _host_index(obj)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.ndim
    n = arr.shape[axis]
    keep = _onp.ones(n, bool)
    if isinstance(obj, slice):
        keep[obj] = False
    else:
        keep[_onp.asarray(obj).reshape(-1)] = False
    return arr.index_select(axis, _torch.as_tensor(_onp.flatnonzero(keep),
                                                   device=arr.device))


def _resize(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    total = _math.prod(shape)
    flat = a.reshape(-1)
    if flat.numel() == 0 or total == 0:
        return _torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-total // flat.numel())
    return flat.repeat(reps)[:total].reshape(shape)


def _invert(x):
    return _torch.logical_not(x) if x.dtype == _torch.bool else \
        _torch.bitwise_not(x)


def _logic(f):
    return _binary(lambda a, b: f(a, b))


def _float_fn(f):
    return lambda x, *a, **k: f(_fl(x), *a, **k)


def _float_bin(f):
    def g(a, b):
        a, b = _pair(a, b)
        dt = _torch.promote_types(a.dtype, b.dtype)
        if not (dt.is_floating_point or dt.is_complex):
            dt = _float_default()
        return f(a.to(dt), b.to(dt))

    return _binary(g)


_IMPL = {
    # unary
    "sin": _float_fn(_torch.sin), "cos": _float_fn(_torch.cos),
    "tan": _float_fn(_torch.tan), "arcsin": _float_fn(_torch.asin),
    "arccos": _float_fn(_torch.acos), "arctan": _float_fn(_torch.atan),
    "sinh": _float_fn(_torch.sinh), "cosh": _float_fn(_torch.cosh),
    "tanh": _float_fn(_torch.tanh), "arcsinh": _float_fn(_torch.asinh),
    "arccosh": _float_fn(_torch.acosh), "arctanh": _float_fn(_torch.atanh),
    "exp": _float_fn(_torch.exp), "expm1": _float_fn(_torch.expm1),
    "log": _float_fn(_torch.log), "log2": _float_fn(_torch.log2),
    "log10": _float_fn(_torch.log10), "log1p": _float_fn(_torch.log1p),
    "sqrt": _float_fn(_torch.sqrt), "cbrt": _cbrt,
    "square": _torch.square, "absolute": _torch.abs, "abs": _torch.abs,
    "sign": _torch.sign, "floor": _torch.floor, "ceil": _torch.ceil,
    "trunc": _torch.trunc, "rint": _torch.round,
    "negative": _torch.neg, "reciprocal": _float_fn(_torch.reciprocal),
    "logical_not": _torch.logical_not, "isnan": _torch.isnan,
    "isinf": _torch.isinf, "isfinite": _torch.isfinite,
    "isneginf": _torch.isneginf, "isposinf": _torch.isposinf,
    "conj": _torch.conj_physical, "real": _real, "imag": _imag,
    "angle": _angle, "degrees": _float_fn(_torch.rad2deg),
    "radians": _float_fn(_torch.deg2rad),
    "ravel": lambda a, order="C": a.reshape(-1), "sort": _sort,
    "unique": _unique, "nonzero": _nonzero, "copy": _copy,
    "diag": lambda v, k=0: _torch.diag(v, k), "diagonal": _diagonal,
    "atleast_1d": _atleast(_torch.atleast_1d),
    "atleast_2d": _atleast(_torch.atleast_2d),
    "atleast_3d": _atleast(_torch.atleast_3d),
    "flatnonzero": _flatnonzero,
    # binary
    "add": _binary(_torch.add), "subtract": _binary(_torch.sub),
    "multiply": _binary(_torch.mul), "divide": _binary(_divide),
    "true_divide": _binary(_divide),
    "floor_divide": _binary(_torch.floor_divide),
    "mod": _binary(_torch.remainder), "remainder": _binary(_torch.remainder),
    "power": _binary(_torch.pow), "float_power": _binary(_torch.float_power),
    "maximum": _binary(_torch.maximum), "minimum": _binary(_torch.minimum),
    "fmax": _binary(_torch.fmax), "fmin": _binary(_torch.fmin),
    "arctan2": _float_bin(_torch.atan2), "hypot": _float_bin(_torch.hypot),
    "logaddexp": _float_bin(_torch.logaddexp),
    "logaddexp2": _float_bin(_torch.logaddexp2),
    "copysign": _float_bin(_torch.copysign),
    "nextafter": _binary(_nextafter),
    "logical_and": _logic(_torch.logical_and),
    "logical_or": _logic(_torch.logical_or),
    "logical_xor": _logic(_torch.logical_xor),
    "equal": _logic(_torch.eq), "not_equal": _logic(_torch.ne),
    "greater": _logic(_torch.gt), "greater_equal": _logic(_torch.ge),
    "less": _logic(_torch.lt), "less_equal": _logic(_torch.le),
    "bitwise_and": _binary(_torch.bitwise_and),
    "bitwise_or": _binary(_torch.bitwise_or),
    "bitwise_xor": _binary(_torch.bitwise_xor),
    "left_shift": _binary(_torch.bitwise_left_shift),
    "right_shift": _binary(_torch.bitwise_right_shift),
    "gcd": _binary(_torch.gcd), "lcm": _binary(_torch.lcm),
    "heaviside": _binary(_heaviside), "ldexp": _binary(_ldexp),
    "dot": _binary(_dot), "vdot": _binary(_vdot),
    "inner": _binary(_torch.inner), "outer": _binary(_outer),
    "matmul": _binary(_torch.matmul), "kron": _binary(_torch.kron),
    "cross": _binary(_cross), "convolve": _binary(_convolve),
    "correlate": _binary(_correlate), "searchsorted": _searchsorted,
    # reductions and statistics
    "sum": _sum, "mean": _mean, "max": _amax, "min": _amin, "amax": _amax,
    "amin": _amin, "prod": _prod, "nanprod": _nanprod, "nansum": _nansum,
    "std": _std, "var": _var, "median": _median, "average": _average,
    "percentile": _percentile, "quantile": _quantile, "ptp": _ptp,
    "argmax": _arg_nanfirst(_torch.argmax),
    "argmin": _arg_nanfirst(_torch.argmin),
    "nanargmax": _nanarg(_torch.argmax, -float("inf")),
    "nanargmin": _nanarg(_torch.argmin, float("inf")),
    "all": _all, "any": _any, "cumsum": _cum(_torch.cumsum),
    "cumprod": _cum(_torch.cumprod), "nancumsum": _cum(_torch.cumsum, 0.0),
    "count_nonzero": _count_nonzero,
    # shapes, joins and splits
    "reshape": _reshape, "transpose": _transpose,
    "swapaxes": lambda a, axis1, axis2: _torch.swapaxes(a, axis1, axis2),
    "moveaxis": lambda a, source, destination: _torch.movedim(
        a, source, destination),
    "rollaxis": _rollaxis, "expand_dims": _expand_dims, "squeeze": _squeeze,
    "concatenate": _concatenate, "stack": _stack,
    "vstack": _seq(_torch.vstack), "hstack": _seq(_torch.hstack),
    "dstack": _seq(_torch.dstack), "column_stack": _seq(_torch.column_stack),
    "split": _split, "array_split": _array_split, "hsplit": _hsplit,
    "vsplit": _vsplit, "dsplit": _dsplit, "tile": _tile, "repeat": _repeat,
    "roll": _roll, "flip": _flip, "fliplr": _torch.fliplr,
    "flipud": _torch.flipud, "rot90": _rot90, "broadcast_to": _broadcast_to,
    "broadcast_arrays": _broadcast_arrays, "append": _append,
    "where": _where, "clip": _clip, "round": _round, "around": _round,
    "argsort": _argsort, "take": _take, "take_along_axis": _take_along_axis,
    "partition": _partition, "argpartition": _argpartition,
    "trace": _trace, "tensordot": _binary(_tensordot), "einsum": _einsum,
    "pad": _pad, "bincount": _bincount, "digitize": _digitize,
    "interp": _interp, "histogram": _histogram, "allclose": _allclose,
    "isclose": _isclose, "array_equal": _array_equal,
    "array_equiv": _array_equiv, "triu": _tri_fn(_torch.triu),
    "tril": _tri_fn(_torch.tril), "meshgrid": _meshgrid,
    "unravel_index": _unravel_index,
    "ravel_multi_index": _ravel_multi_index, "diff": _diff,
    "ediff1d": _ediff1d, "gradient": _gradient, "trapz": _trapz,
    "insert": _insert, "delete": _delete, "resize": _resize,
    "invert": _invert,
}

#: the non-differentiable ones: predicates, comparisons, index outputs
_NO_GRAD = frozenset("""logical_not isnan isinf isfinite isneginf isposinf
    sign floor ceil trunc rint nonzero flatnonzero unique logical_and
    logical_or logical_xor equal not_equal greater greater_equal less
    less_equal bitwise_and bitwise_or bitwise_xor left_shift right_shift
    gcd lcm floor_divide searchsorted argmax argmin nanargmax nanargmin all
    any count_nonzero argsort argpartition bincount digitize histogram
    allclose isclose array_equal array_equiv unravel_index
    ravel_multi_index invert""".split())


# --- creation ----------------------------------------------------------------

def _place(raw, ctx=None, device=None):
    dev = (ctx or device or current_context()).device
    return _np(NDArray(raw.to(dev)))


def array(object, dtype=None, ctx=None, device=None):
    """Reference ``mx.np.array``: floats become float32 (the classic
    default) unless ``mx.util.set_np_default_dtype`` is on; an NDArray is
    taken over (cast to ``dtype`` when given)."""
    if isinstance(object, NDArray):
        out = object.astype(dtype) if dtype is not None else object.copy()
        return _np(out.as_in_context(ctx or device) if (ctx or device)
                    else out)
    if isinstance(object, _torch.Tensor):
        raw = object.detach().clone()
    else:
        arr = _onp.asarray(object)
        raw = _torch.as_tensor(_onp.array(arr))
        if dtype is None and arr.dtype == _onp.float64:
            raw = raw.to(_float_default())
    if dtype is not None:
        raw = raw.to(_resolve_dtype(dtype))
    return _place(raw, ctx, device)


asarray = array


def _dt(dtype, default=None):
    dt = _resolve_dtype(dtype)
    return dt if dt is not None else (default or _float_default())


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype=None, order="C", ctx=None, device=None):
    return _place(_torch.zeros(_shape(shape), dtype=_dt(dtype)), ctx, device)


def ones(shape, dtype=None, order="C", ctx=None, device=None):
    return _place(_torch.ones(_shape(shape), dtype=_dt(dtype)), ctx, device)


def empty(shape, dtype=None, order="C", ctx=None, device=None):
    """Zeros, as the reference's ``empty``."""
    return zeros(shape, dtype, order, ctx, device)


def full(shape, fill_value, dtype=None, order="C", ctx=None, device=None):
    if isinstance(fill_value, NDArray):
        fill_value = fill_value.item()
    return _place(_torch.full(_shape(shape), fill_value, dtype=_dt(dtype)),
                  ctx, device)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    """Integers for integer arguments (int64), else the float default."""
    if stop is None:
        start, stop = 0, start
    ints = _builtins.all(isinstance(v, (int, _onp.integer))
                         for v in (start, stop, step))
    dt = _dt(dtype, _torch.int64 if ints else None)
    return _place(_torch.arange(start, stop, step, dtype=_torch.float64
                                if dt.is_floating_point else _torch.int64)
                  .to(dt), ctx, device)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    n = num if endpoint else num + 1
    r = _torch.linspace(float(start), float(stop), n, dtype=_torch.float64)
    r = r if endpoint else r[:-1]
    out = _place(r.to(_dt(dtype)), ctx, device)
    if retstep:
        return out, (float(stop) - float(start)) / _builtins.max(
            (num - 1) if endpoint else num, 1)
    return out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None, device=None):
    n = num if endpoint else num + 1
    r = _torch.linspace(float(start), float(stop), n, dtype=_torch.float64)
    r = (r if endpoint else r[:-1])
    return _place(_torch.pow(float(base), r).to(_dt(dtype)), ctx, device)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              ctx=None, device=None):
    n = num if endpoint else num + 1
    r = _torch.logspace(_math.log10(start), _math.log10(stop), n,
                        dtype=_torch.float64)
    r = r if endpoint else r[:-1]
    r[0] = start
    if endpoint:
        r[-1] = stop
    return _place(r.to(_dt(dtype)), ctx, device)


def eye(N, M=None, k=0, dtype=None, order="C", ctx=None, device=None):
    out = _torch.zeros((N, M if M is not None else N), dtype=_dt(dtype))
    out.diagonal(k).fill_(1)
    return _place(out, ctx, device)


def identity(n, dtype=None, ctx=None, device=None):
    return eye(n, dtype=dtype, ctx=ctx, device=device)


def tri(N, M=None, k=0, dtype=None, ctx=None, device=None):
    m = M if M is not None else N
    return _place(_torch.tril(_torch.ones((N, m), dtype=_dt(dtype)), k),
                  ctx, device)


def _like(fill):
    def fn(a, dtype=None, order="K", subok=True, shape=None, ctx=None,
           device=None):
        x = a._data if isinstance(a, NDArray) else _t(a)
        dt = _resolve_dtype(dtype) or x.dtype
        s = x.shape if shape is None else _shape(shape)
        raw = _torch.full(s, fill, dtype=dt, device=x.device)
        out = _np(NDArray(raw))
        return out.as_in_context(ctx or device) if (ctx or device) else out

    return fn


zeros_like = _like(0)
ones_like = _like(1)
empty_like = _like(0)


def full_like(a, fill_value, dtype=None, order="K", subok=True, shape=None,
              ctx=None, device=None):
    return _like(fill_value)(a, dtype, order, subok, shape, ctx, device)


def frombuffer(buffer, dtype=float, count=-1, offset=0, ctx=None,
               device=None):
    arr = _onp.frombuffer(buffer, dtype=dtype, count=count, offset=offset)
    return _place(_torch.as_tensor(arr.copy()), ctx, device)


# metadata: plain Python results, not ops

def shape(a):
    return tuple(a.shape) if isinstance(a, NDArray) else _onp.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, NDArray) else _onp.ndim(a)


def size(a, axis=None):
    if isinstance(a, NDArray):
        return a.size if axis is None else a.shape[axis]
    return _onp.size(a, axis)


def _as_dtype(x):
    if isinstance(x, NDArray):
        return x.dtype
    if isinstance(x, _torch.dtype):
        return x
    if isinstance(x, bool):
        return _torch.bool
    if isinstance(x, int):
        return _torch.int64
    if isinstance(x, float):
        return _float_default()
    return _resolve_dtype(x)


def result_type(*args):
    """The promoted ``torch.dtype`` of the arguments (arrays, dtypes,
    scalars)."""
    dts = [_as_dtype(a) for a in args]
    out = dts[0]
    for d in dts[1:]:
        out = _torch.promote_types(out, d)
    return out


def can_cast(from_, to, casting="safe"):
    """numpy's ``can_cast`` between the dtypes (bfloat16 by torch's
    rule)."""
    f, t = _as_dtype(from_), _as_dtype(to)
    if _torch.bfloat16 in (f, t):
        return _torch.can_cast(f, t)
    name = lambda d: str(d).removeprefix("torch.")  # noqa: E731
    return bool(_onp.can_cast(_onp.dtype(name(f)), _onp.dtype(name(t)),
                              casting))


def promote_types(t1, t2):
    return _torch.promote_types(_as_dtype(t1), _as_dtype(t2))


def may_share_memory(a, b, max_work=None):
    if isinstance(a, NDArray) and isinstance(b, NDArray):
        return a._data.untyped_storage().data_ptr() == \
            b._data.untyped_storage().data_ptr()
    return False


shares_memory = may_share_memory


def _install():
    g = globals()
    for nm, fn in _IMPL.items():
        g[nm] = _wrap(fn, nm, no_grad=nm in _NO_GRAD)
        __all__.append(nm)
    __all__.extend(["array", "asarray", "empty", "zeros", "ones", "full",
                    "arange", "linspace", "logspace", "geomspace", "eye",
                    "identity", "tri", "zeros_like", "ones_like",
                    "empty_like", "full_like", "frombuffer"])


_install()
del _install

#: the names of the function table, in its order (every one a
#: ``np_<name>`` op through ``apply_op``)
FUNCTIONS = tuple(_IMPL)

from . import random  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
__all__.extend(["random", "linalg"])

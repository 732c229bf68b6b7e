"""Sparse NDArrays: the ``row_sparse`` and ``csr`` storage types.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference
``include/mxnet/ndarray.h`` kRowSparseStorage/kCSRStorage,
``src/operator/tensor/cast_storage-inl.h`` and the sparse FComputeEx
kernels of ``dot.cc`` and ``elemwise_binary_op_basic.cc``).

A ``RowSparseNDArray`` keeps ``(data, indices)``: ``data[i]`` is the dense
row at ``indices[i]``.  A ``CSRNDArray`` keeps ``(data, indices, indptr)``.
The aux arrays are int64 tensors on the device of the values, which live
on the array's context (``mx.gpu(0)`` by default).  Every step runs as
torch ops on that device, the index-set merges included (sorted
``torch.unique``, ``searchsorted``, ``isin``): the indices come out equal
to the reference's host-numpy merges, and no value leaves the device.  A
data-dependent size (a nonzero pattern, a union) costs one wait on the
card, as the reference's host fetch does.

The elementwise algebra is the reference's ``dispatch_binary`` /
``dispatch_unary`` (wired into the ``mx.nd`` elemwise ops): ± of two
sparse arrays of one stype merges over the union of stored rows or
entries, × over the intersection; × and ÷ against a dense array of the
same shape or a scalar act on the stored entries; a zero-preserving
unary op maps the stored values.  Every other case densifies (the
reference's storage fallback), through ``apply_op``, so a dense operand
inside ``autograd.record()`` keeps its gradient; while recording, the
stored-entry kernels defer to that fallback for the same reason.

``dot`` of a CSR array and a dense one (with ``transpose_a`` /
``transpose_b``) gathers the dense rows by the stored columns (rows,
transposed), scales them by the values and adds them into the output
rows (columns) with ``index_add_`` on the CPU; its gradient reaches the
dense operand (the sparse one is a constant, as in the reference).  On
the card both directions are ``csr_dense_dot``, the hand-written kernel
``csrc/csr_dense_dot.cu`` (a group of lanes a row, the gathers in
flight, the adds in stored order with the CPU's rounding), so card and
CPU agree bit for bit and every run gives the same bits.  The
transposed product runs the same kernel on a column-ordered view of the
array (``_csr_column_view``: a stable sort of the columns keeps each
column's entries in stored order, the order of ``index_add_``); each
direction's gradient is the other direction.  ``to_bcoo`` (a
``jax.experimental.sparse`` type) has no counterpart: it raises naming
ROADMAP.md's "Not carried over".
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels, cuda_graph
from ..base import MXNetError, resolve_dtype
from ..context import current_context
from .ndarray import NDArray

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros",
           "retain", "add", "subtract", "multiply", "divide", "dot",
           "dispatch_unary", "dispatch_binary"]


def _index_tensor(indices, device):
    """Indices as an int64 tensor on ``device`` (the reference stores aux
    indices as int64; float inputs, ``nd.array``'s default, are cast)."""
    if isinstance(indices, NDArray):
        indices = indices._data
    if not isinstance(indices, torch.Tensor):
        indices = torch.as_tensor(np.asarray(indices).astype(np.int64))
    return indices.to(device=device, dtype=torch.int64)


def _values(data, dtype=None, ctx=None):
    """The stored values as an NDArray (on ``ctx``, default: where they
    lie, or the current context for host payloads)."""
    if isinstance(data, NDArray) and dtype is None and ctx is None:
        return data
    return NDArray(data, ctx=ctx, dtype=dtype)


class BaseSparseNDArray:
    """What both sparse types share: host reads through the dense form,
    and arithmetic through the stype-dispatching ``mx.nd`` elemwise ops
    (sparse kernels where they exist, storage fallback otherwise)."""

    @property
    def stype(self):
        raise NotImplementedError

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    def asnumpy(self):
        return self.todense().asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()
        return self

    def tostype(self, stype):
        if stype == "default":
            return self.todense()
        if stype == self.stype:
            return self
        return cast_storage(self, stype)

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)

    def __sub__(self, other):
        return subtract(self, other)

    def __rsub__(self, other):
        return subtract(other, self)

    def __mul__(self, other):
        return multiply(self, other)

    def __rmul__(self, other):
        return multiply(other, self)

    def __truediv__(self, other):
        return divide(self, other)

    def __rtruediv__(self, other):
        return divide(other, self)

    def __neg__(self):
        return _with_values(self, -self.data._data)


class RowSparseNDArray(BaseSparseNDArray):
    """``(data, indices)``: ``data[i]`` is the dense row at
    ``indices[i]`` (reference ``RowSparseNDArray``)."""

    def __init__(self, data, indices, shape):
        self.data = _values(data)
        self.indices = NDArray(_index_tensor(indices, self.data._data.device))
        self._shape = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "row_sparse"

    def todense(self) -> NDArray:
        d = self.data._data
        out = torch.zeros(self._shape, dtype=d.dtype, device=d.device)
        out[self.indices._data] = d
        return NDArray(out)

    def copyto(self, other):
        """Into another ``RowSparseNDArray`` (which takes copies of this
        one's arrays) or a dense target (the dense form)."""
        if isinstance(other, RowSparseNDArray):
            other.data = self.data.copy()
            other.indices = self.indices.copy()
            other._shape = self._shape
            return other
        return self.todense().copyto(other)

    def copy(self):
        return RowSparseNDArray(self.data.copy(), self.indices.copy(),
                                self._shape)

    def as_in_context(self, ctx):
        return RowSparseNDArray(self.data.as_in_context(ctx),
                                self.indices.as_in_context(ctx),
                                self._shape)

    def retain(self, indices):
        """Only the stored rows whose index is in ``indices`` (reference
        ``sparse.retain``)."""
        want = _index_tensor(indices, self.indices._data.device)
        keep = torch.isin(self.indices._data, want)
        return RowSparseNDArray(NDArray(self.data._data[keep]),
                                self.indices._data[keep], self._shape)

    def __repr__(self):
        return (f"\n<RowSparseNDArray {'x'.join(map(str, self._shape))} "
                f"nnz-rows={self.indices.shape[0]} @{self.context}>")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows ``(data, indices, indptr)`` (reference
    ``CSRNDArray``).  Treated as immutable: the per-entry row ids and
    coordinate keys are cached on the array."""

    def __init__(self, data, indices, indptr, shape):
        self.data = _values(data)
        dev = self.data._data.device
        self.indices = NDArray(_index_tensor(indices, dev))
        self.indptr = NDArray(_index_tensor(indptr, dev))
        self._shape = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "csr"

    def todense(self) -> NDArray:
        d = self.data._data
        out = torch.zeros(self._shape, dtype=d.dtype, device=d.device)
        out[_csr_rows(self), self.indices._data] = d
        return NDArray(out)

    def copy(self):
        return CSRNDArray(self.data.copy(), self.indices.copy(),
                          self.indptr.copy(), self._shape)

    def as_in_context(self, ctx):
        return CSRNDArray(self.data.as_in_context(ctx),
                          self.indices.as_in_context(ctx),
                          self.indptr.as_in_context(ctx), self._shape)

    def to_bcoo(self):
        raise MXNetError("CSRNDArray.to_bcoo (a jax.experimental.sparse "
                         "BCOO) has no counterpart in the port (ROADMAP.md, "
                         "Not carried over); sparse.dot is the product")

    def __repr__(self):
        return (f"\n<CSRNDArray {'x'.join(map(str, self._shape))} "
                f"nnz={self.data.shape[0]} @{self.context}>")


# --- constructors (reference mx.nd.sparse.*) --------------------------------

def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``RowSparseNDArray`` from ``(data, indices)`` (on ``ctx``,
    default: the current context) or by casting a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _values(data, dtype, ctx or (None if isinstance(
            data, (NDArray, torch.Tensor)) else current_context()))
        return RowSparseNDArray(data, indices, shape)
    dense = arg1 if isinstance(arg1, NDArray) else \
        NDArray(arg1, ctx=ctx or current_context(), dtype=dtype)
    return cast_storage(dense, "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``CSRNDArray`` from ``(data, indices, indptr)`` (on ``ctx``,
    default: the current context) or by casting a dense array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _values(data, dtype, ctx or (None if isinstance(
            data, (NDArray, torch.Tensor)) else current_context()))
        return CSRNDArray(data, indices, indptr, shape)
    dense = arg1 if isinstance(arg1, NDArray) else \
        NDArray(arg1, ctx=ctx or current_context(), dtype=dtype)
    return cast_storage(dense, "csr")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of ``stype`` (nothing stored) on ``ctx``."""
    dt = resolve_dtype(dtype) or torch.float32
    dev = (ctx or current_context()).device
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            NDArray(torch.zeros((0,) + shape[1:], dtype=dt, device=dev)),
            torch.zeros(0, dtype=torch.int64), shape)
    if stype == "csr":
        return CSRNDArray(NDArray(torch.zeros(0, dtype=dt, device=dev)),
                          torch.zeros(0, dtype=torch.int64),
                          torch.zeros(shape[0] + 1, dtype=torch.int64),
                          shape)
    from . import zeros as dense_zeros

    return dense_zeros(shape, ctx=ctx, dtype=dtype)


def _csr_rows(csr):
    """The row id of each stored entry (int64, on the array's device),
    expanded from ``indptr`` without a wait on the card (the entry count
    is known on the host)."""
    cached = getattr(csr, "_rows_cache", None)
    if cached is not None:
        return cached
    ptr = csr.indptr._data
    csr._rows_cache = torch.repeat_interleave(
        torch.arange(csr.shape[0], device=ptr.device), torch.diff(ptr),
        output_size=csr.data.shape[0])
    return csr._rows_cache


def _rows_to_indptr(rows, n_rows):
    """Sorted per-entry row ids → ``indptr``."""
    counts = torch.bincount(rows, minlength=n_rows)
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=rows.device),
                      torch.cumsum(counts, 0)])


def cast_storage(data, stype):
    """Convert between ``default``, ``row_sparse`` and ``csr`` (reference
    ``cast_storage``); the nonzero pattern is found on the device."""
    if stype == "default":
        return data.todense() if isinstance(data, BaseSparseNDArray) \
            else data
    if stype not in ("row_sparse", "csr"):
        raise MXNetError(f"unknown stype {stype}")
    if isinstance(data, BaseSparseNDArray):
        if data.stype == stype:
            return data
        if isinstance(data, RowSparseNDArray):  # → csr
            if len(data.shape) != 2:
                raise MXNetError("csr requires 2D")
            vals = data.data._data
            r_in, cols = torch.nonzero(vals != 0, as_tuple=True)
            rows = data.indices._data[r_in]
            order = torch.argsort(rows, stable=True)
            return CSRNDArray(NDArray(vals[r_in[order], cols[order]]),
                              cols[order],
                              _rows_to_indptr(rows[order], data.shape[0]),
                              data.shape)
        rows = _csr_rows(data)  # csr → row_sparse
        nz_rows = torch.unique(rows, sorted=True)
        out = torch.zeros((len(nz_rows), data.shape[1]),
                          dtype=data.dtype, device=rows.device)
        out[torch.searchsorted(nz_rows, rows), data.indices._data] = \
            data.data._data
        return RowSparseNDArray(NDArray(out), nz_rows, data.shape)
    raw = data._data if isinstance(data, NDArray) else torch.as_tensor(data)
    if stype == "row_sparse":
        mask = (raw != 0).reshape(raw.shape[0], -1).any(1)
        nz_rows = torch.nonzero(mask).reshape(-1)
        return RowSparseNDArray(NDArray(raw[nz_rows]), nz_rows, raw.shape)
    if raw.ndim != 2:
        raise MXNetError("csr requires 2D")
    rows, cols = torch.nonzero(raw != 0, as_tuple=True)  # row-major
    return CSRNDArray(NDArray(raw[rows, cols]), cols,
                      _rows_to_indptr(rows, raw.shape[0]), raw.shape)


def retain(data, indices):
    """Module-level ``mx.nd.sparse.retain``."""
    return data.retain(indices)


# --- the FComputeEx-style elemwise algebra ----------------------------------
# Dispatch keys on (op, lhs stype, rhs stype); anything without a sparse
# kernel densifies, as the reference's FallBackCompute does.

#: unary ops with f(0) == 0: applying f to the stored values alone is
#: exact, so the structure and indices are kept
_ZERO_PRESERVING = frozenset({
    "abs", "sign", "ceil", "floor", "rint", "round", "trunc", "fix",
    "sqrt", "cbrt", "square", "negative", "relu", "softsign", "sin",
    "tan", "arcsin", "arctan", "sinh", "tanh", "arcsinh", "arctanh",
    "expm1", "log1p", "erf", "erfinv", "degrees", "radians", "identity",
})


def _with_values(sp, new_vals):
    """The same structure with new stored values."""
    if isinstance(sp, RowSparseNDArray):
        return RowSparseNDArray(NDArray(new_vals), sp.indices, sp.shape)
    out = CSRNDArray(NDArray(new_vals), sp.indices, sp.indptr, sp.shape)
    for cache in ("_rows_cache", "_keys_cache"):
        if hasattr(sp, cache):
            setattr(out, cache, getattr(sp, cache))
    return out


def _call(tf, a, b):
    """``tf`` on tensors, a python scalar operand made a 0-d tensor as
    the dense elemwise ops make it."""
    from ..ops.elemwise import _scalar

    if not isinstance(a, torch.Tensor):
        a = _scalar(a, b)
    if not isinstance(b, torch.Tensor):
        b = _scalar(b, a)
    return tf(a, b)


def dispatch_unary(name, tf, data):
    """Sparse unary: zero-preserving ops map the stored values; the rest
    are dense by definition (storage fallback)."""
    if name in _ZERO_PRESERVING:
        return _with_values(data, tf(data.data._data))
    return NDArray(tf(data.todense()._data))


def _first_positions(arr, values):
    """For each of ``values`` (all present in ``arr``), the first index
    of it in ``arr`` (``np.intersect1d``'s ``return_indices``)."""
    order = torch.argsort(arr, stable=True)
    return order[torch.searchsorted(arr[order], values)]


def _union_merge(tf, ka, va, kb, vb, width):
    """``tf`` over the union of two key sets: each side scattered into
    the sorted union (zeros where it stores nothing)."""
    union = torch.unique(torch.cat([ka, kb]), sorted=True)
    dt = torch.promote_types(va.dtype, vb.dtype)
    out_a = torch.zeros((len(union),) + width, dtype=dt, device=va.device)
    out_b = torch.zeros_like(out_a)
    out_a[torch.searchsorted(union, ka)] = va.to(dt)
    out_b[torch.searchsorted(union, kb)] = vb.to(dt)
    return union, tf(out_a, out_b)


def _intersection_merge(tf, ka, va, kb, vb):
    """``tf`` over the keys both sides store."""
    ua = torch.unique(ka, sorted=True)
    common = ua[torch.isin(ua, kb)]
    return common, tf(va[_first_positions(ka, common)],
                      vb[_first_positions(kb, common)])


def _csr_keys(csr):
    """Flat row-major coordinate keys of the stored entries (cached)."""
    cached = getattr(csr, "_keys_cache", None)
    if cached is None:
        cached = csr._keys_cache = _csr_rows(csr) * csr.shape[1] + \
            csr.indices._data
    return cached


def _csr_from_keys(keys, vals, shape):
    return CSRNDArray(NDArray(vals), keys % shape[1],
                      _rows_to_indptr(keys // shape[1], shape[0]), shape)


def _merge(tf, a, b, union):
    if isinstance(a, RowSparseNDArray):
        ka, kb = a.indices._data, b.indices._data
        if union:
            keys, vals = _union_merge(tf, ka, a.data._data, kb,
                                      b.data._data, tuple(a.shape[1:]))
        else:
            keys, vals = _intersection_merge(tf, ka, a.data._data, kb,
                                             b.data._data)
        return RowSparseNDArray(NDArray(vals), keys, a.shape)
    ka, kb = _csr_keys(a), _csr_keys(b)
    if union:
        keys, vals = _union_merge(tf, ka, a.data._data, kb, b.data._data,
                                  ())
    else:
        keys, vals = _intersection_merge(tf, ka, a.data._data, kb,
                                         b.data._data)
    return _csr_from_keys(keys, vals, a.shape)


def _dense_on_tape(x):
    """True when ``x`` is a dense operand inside ``autograd.record()``
    that is on the graph: a stored-entry kernel would cut its gradient,
    so the dispatch takes the fallback (dense output through
    ``apply_op``)."""
    from .. import autograd as ag

    return ag.is_recording() and x._data.requires_grad


def _gather_dense_at(sp, dense_raw):
    """The dense tensor's values at the sparse array's stored
    coordinates."""
    if isinstance(sp, RowSparseNDArray):
        return dense_raw[sp.indices._data]
    return dense_raw.reshape(-1)[_csr_keys(sp)]


def dispatch_binary(name, tf, lhs, rhs):
    """FComputeEx dispatch of the elemwise binary family.

    Sparse kernels (everything else densifies):
      rsp ± rsp → rsp (union)        csr ± csr → csr (union)
      rsp × rsp → rsp (intersect)    csr × csr → csr (intersect)
      sparse × dense, sparse ÷ dense → sparse (stored entries; same shape)
      sparse × scalar, sparse ÷ scalar, sparse ± 0 → sparse
    Division against a dense array or a scalar is defined on the stored
    entries (the implicit zeros stay zero), the reference's sparse
    division, not IEEE 0/0."""
    l_sp = isinstance(lhs, BaseSparseNDArray)
    r_sp = isinstance(rhs, BaseSparseNDArray)
    if l_sp and r_sp:
        if lhs.shape != rhs.shape or lhs.stype != rhs.stype:
            return _fallback_binary(tf, lhs, rhs)
        if name in ("add", "subtract"):
            return _merge(tf, lhs, rhs, union=True)
        if name == "multiply":
            return _merge(tf, lhs, rhs, union=False)
        return _fallback_binary(tf, lhs, rhs)
    if l_sp and isinstance(rhs, NDArray):
        if name in ("multiply", "divide") and rhs.shape == lhs.shape:
            if not _dense_on_tape(rhs):
                return _with_values(lhs, tf(
                    lhs.data._data, _gather_dense_at(lhs, rhs._data)))
            if name == "divide":
                # the recorded route keeps the stored-entry semantics:
                # unstored coordinates give 0 (and no gradient), never
                # 0/0 (the denominator is made safe before the divide,
                # so its backward sees no NaN either)
                def masked(s, d):
                    mask = s != 0
                    safe = torch.where(mask, d, torch.ones((), dtype=d.dtype,
                                                           device=d.device))
                    return torch.where(mask, tf(s, safe), torch.zeros(
                        (), dtype=torch.result_type(s, d), device=d.device))

                return _fallback_binary(masked, lhs, rhs)
        return _fallback_binary(tf, lhs, rhs)
    if r_sp and isinstance(lhs, NDArray):
        if name == "multiply" and lhs.shape == rhs.shape and \
                not _dense_on_tape(lhs):
            return _with_values(rhs, tf(_gather_dense_at(rhs, lhs._data),
                                        rhs.data._data))
        return _fallback_binary(tf, lhs, rhs)
    if l_sp and np.isscalar(rhs):
        if name in ("multiply", "divide") or \
                (name in ("add", "subtract") and rhs == 0):
            return _with_values(lhs, _call(tf, lhs.data._data, rhs))
        return _fallback_binary(tf, lhs, rhs)
    if r_sp and np.isscalar(lhs):
        if name == "multiply" or (name == "add" and lhs == 0):
            return _with_values(rhs, _call(tf, lhs, rhs.data._data))
        return _fallback_binary(tf, lhs, rhs)
    return _fallback_binary(tf, lhs, rhs)


def _fallback_binary(tf, lhs, rhs):
    """Storage fallback: densify the sparse operands, dense output,
    through ``apply_op`` (a dense operand inside ``autograd.record()``
    keeps its gradient; the densified sparse operand is a constant)."""
    from ..ops.registry import apply_op

    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    if isinstance(a, NDArray) and isinstance(b, NDArray):
        return apply_op(tf, a, b, name="sparse_fallback")
    if isinstance(a, NDArray):
        return apply_op(lambda x: _call(tf, x, b), a, name="sparse_fallback")
    return apply_op(lambda y: _call(tf, a, y), b, name="sparse_fallback")


def _ew(name):
    """The stype-dispatching ``mx.nd`` elemwise op (imported late: the
    ops module imports this one)."""
    from ..ops import elemwise

    return getattr(elemwise, name)


def add(lhs, rhs):
    return _ew("add")(lhs, rhs)


def subtract(lhs, rhs):
    return _ew("subtract")(lhs, rhs)


def multiply(lhs, rhs):
    return _ew("multiply")(lhs, rhs)


def divide(lhs, rhs):
    return _ew("divide")(lhs, rhs)


# --- dot ---------------------------------------------------------------------

def _csr_dense_dot(data, cols, rows, n_out, rhs, transpose_a=False):
    """``A @ rhs`` (``Aᵀ @ rhs`` with ``transpose_a``) for the sparse
    ``A`` given by its stored values ``data`` at (``rows``, ``cols``):
    the rows of ``rhs`` at the stored columns (rows), scaled by the
    values, added into the output rows (columns) by ``index_add_``.
    ``n_out`` is the output's row count.  Differentiable in ``rhs``."""
    src, dst = (rows, cols) if transpose_a else (cols, rows)
    dt = torch.promote_types(data.dtype, rhs.dtype)
    contrib = rhs.index_select(0, src).to(dt) * \
        data.to(dt).reshape((-1,) + (1,) * (rhs.ndim - 1))
    out = torch.zeros((n_out,) + tuple(rhs.shape[1:]), dtype=dt,
                      device=rhs.device)
    return out.index_add(0, dst, contrib)


_DOT_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.bfloat16: 3}


def _csr_column_view(data, cols, rows, n_cols):
    """``A`` in column order, as the CSR array of ``Aᵀ``: ``(data, cols,
    indptr, rows)`` of the transpose, each column's entries in their
    stored order (a stable sort of the columns), so that a product that
    adds each output row's terms in stored order adds ``Aᵀ @ rhs`` in the
    order of ``index_add_`` over the original entries.  The columns are
    sorted as int32 where they fit (half the radix passes of int64 on the
    card); the column pointers are ``searchsorted`` over the sorted
    columns (``bincount`` would read its bounds back to the host)."""
    key = cols.to(torch.int32) if n_cols <= torch.iinfo(torch.int32).max \
        else cols
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_cols = sorted_key.to(torch.int64)
    indptr = torch.searchsorted(
        sorted_cols, torch.arange(n_cols + 1, device=cols.device))
    return data[perm], rows[perm], indptr, sorted_cols


def csr_dense_dot(data, cols, indptr, rows, rhs, transpose_a=False,
                  n_cols=None):
    """``A @ rhs`` (``Aᵀ @ rhs`` with ``transpose_a``; ``n_cols``, the
    columns of ``A``, is then the output's row count) for the CSR ``A``
    given by its stored values ``data``, their columns ``cols``,
    ``indptr`` and each entry's row ``rows``; ``rhs`` is 2-D.
    Differentiable in ``rhs``.  CPU tensors take the plain version
    (``_csr_dense_dot``).  CUDA tensors launch ``csrc/csr_dense_dot.cu``
    in both directions: the transposed product on the column-ordered view
    (``_csr_column_view``); ``csr_dense_dot.launches`` counts the
    non-transposed launches, ``.launches_transposed`` the others.  The
    backward is the product in the other direction, on the same kernel."""
    if transpose_a and n_cols is None:
        raise MXNetError("csr_dense_dot: transpose_a needs n_cols")
    if all(t.device.type == "cpu" for t in (data, cols, indptr, rhs)):
        n_out = n_cols if transpose_a else indptr.numel() - 1
        return _csr_dense_dot(data, cols, rows, n_out, rhs, transpose_a)
    _kernels.refuse_trace("csr_dense_dot", data, rhs)
    return _CSRDenseDot.apply(rhs, data, cols, indptr, rows, n_cols,
                              transpose_a)


csr_dense_dot.launches = 0
csr_dense_dot.launches_transposed = 0


class _CSRDenseDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, data, cols, indptr, rows, n_cols, transpose_a):
        ctx.save_for_backward(data, cols, indptr, rows)
        # A's columns: the backward of A @ rhs is the transposed product,
        # whose output has one row a row of rhs
        ctx.meta = (n_cols if transpose_a else rhs.shape[0], transpose_a,
                    rhs.dtype)
        return _csr_dense_dot_cuda(data, cols, indptr, rows, n_cols, rhs,
                                   transpose_a)

    @staticmethod
    def backward(ctx, grad):
        data, cols, indptr, rows = ctx.saved_tensors
        n_cols, transpose_a, dtype = ctx.meta
        g = _csr_dense_dot_cuda(data, cols, indptr, rows, n_cols, grad,
                                not transpose_a)
        return g.to(dtype), None, None, None, None, None, None


def _csr_dense_dot_cuda(data, cols, indptr, rows, n_cols, rhs,
                        transpose_a):
    """One launch of the kernel (after the column-ordered view, with
    ``transpose_a``): the operands in their promoted dtype, contiguous, on
    one card."""
    dt = torch.promote_types(data.dtype, rhs.dtype)
    dev = rhs.device
    # the rhs rows the entries name: A's columns, or with transpose_a its
    # rows
    k = indptr.numel() - 1 if transpose_a else n_cols
    if rhs.ndim != 2 or dt not in _DOT_CODES or not rhs.is_cuda or \
            cols.dtype != torch.int64 or indptr.dtype != torch.int64 or \
            rows.dtype != torch.int64 or \
            any(t.device != dev for t in (data, cols, indptr, rows)) or \
            data.shape != cols.shape or rows.shape != cols.shape or \
            (k is not None and rhs.shape[0] != k):
        raise MXNetError(
            "csr_dense_dot: expected float data, int64 cols/indptr/rows of "
            "one CSR array and a 2-D float rhs on one CUDA device; got "
            f"data {data.dtype} {tuple(data.shape)} on {data.device}, "
            f"cols {cols.dtype}, indptr {indptr.dtype} on {indptr.device}, "
            f"rows {rows.dtype}, rhs {rhs.dtype} {tuple(rhs.shape)} on "
            f"{dev}")
    if transpose_a:
        data, cols, indptr, _ = _csr_column_view(data, cols, rows, n_cols)
    n_rows, n = indptr.numel() - 1, rhs.shape[1]
    out = torch.empty((n_rows, n), dtype=dt, device=dev)
    vals = data.to(dt).contiguous()
    dense = rhs.to(dt).contiguous()
    lib = _kernels.load("csr_dense_dot")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxt_csr_dense_dot(
            vals.data_ptr(), cols.contiguous().data_ptr(),
            indptr.contiguous().data_ptr(), dense.data_ptr(),
            out.data_ptr(), n_rows, n, _DOT_CODES[dt], stream)
    _kernels.check(lib, err, "csr_dense_dot launch")
    cuda_graph.count(csr_dense_dot, "launches_transposed" if transpose_a
                     else "launches")
    return out


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware ``dot``: CSR × dense through ``csr_dense_dot``; any
    other sparse operand densifies (reference FComputeEx dispatch).

    Autograd: the dense operand's gradient flows (the product runs
    through ``apply_op``); the sparse operand is a constant, as in the
    reference."""
    from ..ops.registry import apply_op

    if isinstance(lhs, CSRNDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        rows = _csr_rows(lhs)
        n_out = lhs.shape[1] if transpose_a else lhs.shape[0]

        def f(r):
            if transpose_b:
                r = r.permute(*reversed(range(r.ndim)))
            vec = r.ndim == 1
            r2 = r.unsqueeze(1) if vec else r.reshape(r.shape[0], -1)
            out = csr_dense_dot(lhs.data._data, lhs.indices._data,
                                lhs.indptr._data, rows, r2, transpose_a,
                                lhs.shape[1])
            return out.squeeze(1) if vec else \
                out.reshape((n_out,) + tuple(r.shape[1:]))

        return apply_op(f, rhs, name="sparse_dot")
    from . import dot as dense_dot

    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return dense_dot(a, b, transpose_a=transpose_a, transpose_b=transpose_b)

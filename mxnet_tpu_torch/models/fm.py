"""The factorization machine: the parameter-server-shaped sparse workload.

Counterpart of ``mxnet_tpu/models/fm.py`` (reference
``example/sparse/factorization_machine/``): CSR minibatches from
``io.LibSVMIter``, row-sparse gradients of the linear weights ``w`` and
the factor table ``v`` pushed through a KVStore, and the updated rows
pulled back with ``row_sparse_pull``.

The score uses the O(nnz·K) identity ``½[(Xv)² − X²v²]`` with the CSR ×
dense products of ``ndarray/sparse.py``.  The gradients are written out
by hand (logistic loss), as in the reference; those of ``w`` and ``v``
are nonzero only on the rows the batch touches, and ``step`` hands them
on as ``RowSparseNDArray``s over those rows.  The tables live on the
model's context (``mx.gpu(0)`` by default) and ``v`` is drawn from
``np.random.RandomState(seed).normal(0, 0.05)``, the reference's own draw,
so one seed gives the same tables in both packages.

When the store applies an optimizer (``set_optimizer``: the local store,
``dist_sync``, or a ``dist_async`` parameter server), ``step`` pushes the
gradients, and pulls back ``w`` and ``v`` with ``row_sparse_pull`` over
the touched rows and ``w0`` with ``pull``: every other row of the model's
tables stays as it was, bit for bit.  Without one it updates the touched
rows by plain SGD in place.  (The reference reads the store's
``_updater``, which its ``dist_sync`` and ``dist_async`` worker stores do
not have, so there its model trains locally; here both stores report the
optimizer they apply.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import current_context
from ..ndarray import NDArray
from ..base import MXNetError  # noqa: F401

__all__ = ["FMModel"]


def _store_updates(kv):
    """Does the store apply an optimizer to what is pushed?"""
    if getattr(kv, "_updater", None) is not None:
        return True
    return bool(getattr(kv, "updates_on_server", False))


class FMModel:
    """y = w0 + X·w + ½ Σ_f [(X·v)² − X²·v²] for a sparse (CSR) X.

    The parameters live in a KVStore (default ``local``) under the keys
    ``fm_w0``, ``fm_w`` and ``fm_v``, and on ``ctx`` (default: the
    current context)."""

    def __init__(self, num_features, factor_dim=8, lr=0.01, kvstore=None,
                 seed=0, ctx=None):
        from .. import kvstore as kvs
        from .. import ndarray as nd

        ctx = ctx or current_context()
        rng = np.random.RandomState(seed)
        self.n = num_features
        self.k = factor_dim
        self.lr = lr
        self.ctx = ctx
        self.w0 = nd.zeros((1,), ctx=ctx)
        self.w = nd.zeros((num_features, 1), ctx=ctx)
        self.v = NDArray(rng.normal(0, 0.05, (num_features, factor_dim))
                         .astype(np.float32), ctx=ctx)
        self.kv = kvs.create(kvstore) if isinstance(kvstore, str) \
            else (kvstore or kvs.create("local"))
        self.kv.init("fm_w0", self.w0)
        self.kv.init("fm_w", self.w)
        self.kv.init("fm_v", self.v)

    # -- forward --------------------------------------------------------------
    def _score_parts(self, csr):
        from ..ndarray import sparse as sp

        xv = sp.dot(csr, self.v)                     # (B, K)
        x2 = self._square_csr(csr)
        x2v2 = sp.dot(x2, self.v * self.v)           # (B, K)
        linear = sp.dot(csr, self.w)                 # (B, 1)
        return xv, x2v2, linear, x2

    def _logits(self, xv, x2v2, linear):
        from .. import ndarray as nd

        inter = 0.5 * nd.sum(xv * xv - x2v2, axis=1, keepdims=True)
        return self.w0 + linear + inter              # (B, 1)

    @staticmethod
    def _square_csr(csr):
        from ..ndarray import sparse as sp

        return sp._with_values(csr, csr.data._data * csr.data._data)

    def forward(self, csr):
        """The (B, 1) logits of a CSR batch."""
        xv, x2v2, linear, _x2 = self._score_parts(csr)
        return self._logits(xv, x2v2, linear)

    __call__ = forward

    # -- one step -------------------------------------------------------------
    def step(self, csr, labels):
        """One logistic-loss step on a CSR batch; returns the loss (a
        host float).  The gradients of ``w`` and ``v`` are
        ``RowSparseNDArray``s over the batch's feature rows."""
        from .. import ndarray as nd
        from ..ndarray import sparse as sp

        b = csr.shape[0]
        xv, x2v2, linear, x2 = self._score_parts(csr)
        logits = self._logits(xv, x2v2, linear)
        y = labels.reshape((b, 1))
        p = nd.sigmoid(logits)
        dlogit = (p - y) / b                          # dL/dlogit, mean loss
        loss = -nd.mean(y * nd.log(p + 1e-12)
                        + (1 - y) * nd.log(1 - p + 1e-12))

        # w0 ← Σ dlogit; w ← Xᵀ dlogit; v ← Xᵀ(dlogit·Xv) − (X²ᵀ dlogit)·v
        g_w0 = nd.sum(dlogit).reshape((1,))
        g_w_dense = sp.dot(csr, dlogit, transpose_a=True)   # (N, 1)
        t1 = sp.dot(csr, dlogit * xv, transpose_a=True)     # (N, K)
        t2 = sp.dot(x2, dlogit, transpose_a=True) * self.v  # (N, K)
        g_v_dense = t1 - t2

        rows = self._touched_rows(csr)
        g_w = self._rowslice(g_w_dense, rows)
        g_v = self._rowslice(g_v_dense, rows)

        if _store_updates(self.kv):
            # the PS round trip: push the row-sparse gradients, the store
            # updates, pull back only the touched rows
            self.kv.push("fm_w0", g_w0)
            self.kv.push("fm_w", g_w)
            self.kv.push("fm_v", g_v)
            self.kv.row_sparse_pull("fm_w", out=self.w, row_ids=rows)
            self.kv.row_sparse_pull("fm_v", out=self.v, row_ids=rows)
            self.kv.pull("fm_w0", out=self.w0)
        else:
            # no optimizer in the store: local SGD (a push would replace
            # the stored weights, as the reference's local store does)
            self._local_sgd(g_w0, g_w, g_v, rows)
        return float(loss.asscalar())

    @staticmethod
    def _touched_rows(csr):
        """The sorted distinct feature ids of the batch (int64, on its
        device)."""
        return NDArray(torch.unique(csr.indices._data, sorted=True))

    @staticmethod
    def _rowslice(dense, rows):
        from ..ndarray import sparse as sp

        return sp.RowSparseNDArray(NDArray(dense._data[rows._data]), rows,
                                   dense.shape)

    def _local_sgd(self, g_w0, g_w, g_v, rows):
        idx = rows._data
        with torch.no_grad():
            self.w0._data = self.w0._data - self.lr * g_w0._data
            self.w._data.index_add_(0, idx, -self.lr * g_w.data._data)
            self.v._data.index_add_(0, idx, -self.lr * g_v.data._data)

    # -- evaluation -----------------------------------------------------------
    def accuracy(self, csr, labels):
        """The share of the batch whose thresholded score equals its
        label."""
        from .. import ndarray as nd

        pred = (nd.sigmoid(self.forward(csr)) > 0.5).reshape((-1,))
        return float(nd.mean(pred == labels).asscalar())

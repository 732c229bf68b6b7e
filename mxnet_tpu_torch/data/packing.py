"""Sequence packing: variable-length documents onto one fixed grid.

Counterpart of ``mxnet_tpu/data/packing.py``.  Pretraining corpora are
ragged; a step wants one ``(batch, seq_len)`` shape (one set of buffers,
one captured graph).  The packer first-fits each document of a step's
draw into a fixed ``(batch_size, seq_len)`` grid and emits **segment
ids**, so attention can keep packed documents from seeing each other
(``models/llama.py`` builds the ``causal & same-segment`` mask from
them).

Determinism: packing is a pure function of the document list (first-fit
in draw order, no sorting, no random draw), so every rank that packs the
same global draw gets the same grid and keeps its rows through
``elastic.shard_rows``; an elastic 2→1→2 resize stays exact through the
packed path.

``PackingStats.efficiency`` is tokens kept over grid capacity.
"""
from __future__ import annotations

import threading

import numpy as np

from ..base import MXNetError

__all__ = ["PackedBatch", "PackingStats", "SequencePacker",
           "pack_documents"]


class PackingStats:
    """Running token-accounting across packed batches."""

    __slots__ = ("tokens_kept", "tokens_padded", "tokens_dropped",
                 "docs_packed", "docs_dropped", "batches")

    def __init__(self):
        self.tokens_kept = 0
        self.tokens_padded = 0
        self.tokens_dropped = 0
        self.docs_packed = 0
        self.docs_dropped = 0
        self.batches = 0

    def efficiency(self):
        """Tokens kept / grid capacity (kept + padded) in [0, 1]."""
        total = self.tokens_kept + self.tokens_padded
        return self.tokens_kept / total if total else 0.0

    def merge(self, other):
        """Fold another stats object into this one (the packer merges
        per-batch locals under a lock — decode workers pack steps
        concurrently)."""
        for f in self.__slots__:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def as_dict(self):
        return {"tokens_kept": self.tokens_kept,
                "tokens_padded": self.tokens_padded,
                "tokens_dropped": self.tokens_dropped,
                "docs_packed": self.docs_packed,
                "docs_dropped": self.docs_dropped,
                "batches": self.batches,
                "efficiency": self.efficiency()}


class PackedBatch:
    """One fixed-signature packed batch.

    ``tokens``       (B, T) int32 — documents back to back, 0-padded
    ``segment_ids``  (B, T) int32 — 0 = padding, 1..n per row
    ``labels``       (B, T) int32 — next token within the same segment
    ``loss_mask``    (B, T) float32 — 1 where ``labels`` is a real
                     next-token target: padding and each segment's last
                     position are masked (no cross-document prediction)
    """

    __slots__ = ("tokens", "segment_ids", "labels", "loss_mask")

    def __init__(self, tokens, segment_ids, labels, loss_mask):
        self.tokens = tokens
        self.segment_ids = segment_ids
        self.labels = labels
        self.loss_mask = loss_mask

    @property
    def shape(self):
        return self.tokens.shape

    def rows(self, row_idx):
        """A row-sliced view (each rank keeps ``elastic.shard_rows``)."""
        r = np.asarray(row_idx)
        return PackedBatch(self.tokens[r], self.segment_ids[r],
                           self.labels[r], self.loss_mask[r])


class SequencePacker:
    """Greedy first-fit packer onto a fixed ``(batch_size, seq_len)``
    grid.

    Documents are placed in draw order into the first row with room
    (first-fit keeps the operation deterministic AND order-stable — no
    sorting, so the same draw always packs the same way).  A document
    longer than ``seq_len`` is truncated; a document that fits no row is
    dropped and counted in ``stats.tokens_dropped``.
    """

    def __init__(self, batch_size, seq_len):
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        if self.batch_size <= 0 or self.seq_len <= 0:
            raise MXNetError("batch_size and seq_len must be positive")
        self.stats = PackingStats()
        self._stats_lock = threading.Lock()

    def pack(self, documents):
        """Pack a list of 1-D int token arrays into one PackedBatch."""
        B, T = self.batch_size, self.seq_len
        tokens = np.zeros((B, T), dtype=np.int32)
        seg = np.zeros((B, T), dtype=np.int32)
        fill = np.zeros(B, dtype=np.int64)   # next free column per row
        nseg = np.zeros(B, dtype=np.int32)   # segments placed per row
        st = PackingStats()
        for doc in documents:
            d = np.asarray(doc, dtype=np.int32).ravel()
            if d.size == 0:
                continue
            if d.size > T:
                st.tokens_dropped += d.size - T
                d = d[:T]
            n = d.size
            placed = False
            for row in range(B):
                if T - fill[row] >= n:
                    c = fill[row]
                    tokens[row, c:c + n] = d
                    nseg[row] += 1
                    seg[row, c:c + n] = nseg[row]
                    fill[row] = c + n
                    st.tokens_kept += n
                    st.docs_packed += 1
                    placed = True
                    break
            if not placed:
                st.tokens_dropped += n
                st.docs_dropped += 1
        st.tokens_padded += int(B * T - fill.sum())
        st.batches += 1
        with self._stats_lock:
            self.stats.merge(st)

        # next-token labels within each segment: label[t] = tokens[t+1]
        # when t+1 is the same segment; everything else is masked out
        labels = np.zeros((B, T), dtype=np.int32)
        labels[:, :-1] = tokens[:, 1:]
        same = np.zeros((B, T), dtype=bool)
        same[:, :-1] = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)
        loss_mask = same.astype(np.float32)
        labels[~same] = 0
        return PackedBatch(tokens, seg, labels, loss_mask)


def pack_documents(documents, batch_size, seq_len):
    """One-shot convenience: ``(PackedBatch, PackingStats)``."""
    p = SequencePacker(batch_size, seq_len)
    batch = p.pack(documents)
    return batch, p.stats

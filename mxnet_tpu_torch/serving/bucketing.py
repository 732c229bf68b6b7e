"""Power-of-two batch/length bucketing — the compiled-signature budget.

Counterpart of ``mxnet_tpu/serving/bucketing.py`` (the port keeps its
own copy).

In the reference every distinct (batch, length) shape is one XLA
compile.  The port runs eager PyTorch, so nothing compiles per shape
yet, but the same buckets bound the set of shapes the engine runs (its
``compiled_signatures``), which per-shape CUDA graphs will key on
(ROADMAP Queue 1 item 4).  The bucketing policy rounds both axes up to
powers of two, so the whole signature space is
``len(batch_buckets) × len(length_buckets)`` — small and enumerable,
and the padding waste bounded below 2× per axis.

Pure host-side shape math (numpy only, nothing traced) so the tier-1
bucketing tests are exact and the scheduler can call it per batch with
no device cost.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["pow2_bucket", "BucketPolicy", "pad_length", "pad_batch"]


def pow2_bucket(n, lo, hi):
    """Smallest power of two >= ``n``, clamped to [lo, hi].  ``n`` above
    ``hi`` raises — the caller's admission check rejects oversized
    requests before they reach a compile."""
    if n > hi:
        raise MXNetError(f"size {n} exceeds bucket ceiling {hi}")
    b = max(1, int(lo))
    while b < n:
        b *= 2
    return min(b, hi)


class BucketPolicy:
    """The signature budget: which (batch, length) shapes may compile.

    ``batch_bucket(n)`` / ``length_bucket(l)`` round up to the policy's
    power-of-two grid; ``signatures()`` enumerates the full compiled-
    shape space (its length is the hard ceiling on CachedOp signatures
    the server can create — the acceptance tests assert against it).
    """

    def __init__(self, max_batch=8, max_length=128, min_batch=1,
                 min_length=8):
        if max_batch < min_batch or max_length < min_length:
            raise MXNetError("bucket ceilings below floors")
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.min_length = int(min_length)
        self.max_length = int(max_length)

    def batch_bucket(self, n):
        return pow2_bucket(n, self.min_batch, self.max_batch)

    def length_bucket(self, length):
        return pow2_bucket(length, self.min_length, self.max_length)

    def _axis(self, lo, hi):
        vals = []
        b = lo
        while b < hi:
            vals.append(b)
            b *= 2
        vals.append(hi)
        return vals

    def batch_buckets(self):
        return self._axis(self.min_batch, self.max_batch)

    def length_buckets(self):
        return self._axis(self.min_length, self.max_length)

    def signatures(self):
        """Every (batch_bucket, length_bucket) the policy can emit."""
        return [(b, l) for b in self.batch_buckets()
                for l in self.length_buckets()]


def pad_length(array, bucket, axis=0):
    """Zero-pad one example's ``axis`` up to ``bucket`` rows.  Padding
    is zeros: the serving bit-identity contract (docs/serving.md)
    requires models whose per-row outputs don't read other rows
    (position-wise heads), so pad rows change nothing in real rows and
    are sliced off at demux."""
    arr = np.asarray(array)
    n = arr.shape[axis]
    if n > bucket:
        raise MXNetError(f"length {n} exceeds bucket {bucket}")
    if n == bucket:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, bucket - n)
    return np.pad(arr, widths)


def pad_batch(examples, batch_bucket, length_bucket, axis=0):
    """Stack per-request examples into one (batch_bucket, ...) batch,
    length-padding each to ``length_bucket`` first.  Vacant batch rows
    repeat the first (padded) example — real values, so no denormal/NaN
    surprises — and are never demuxed back out."""
    if not examples:
        raise MXNetError("pad_batch needs at least one example")
    if len(examples) > batch_bucket:
        raise MXNetError(
            f"{len(examples)} examples exceed batch bucket {batch_bucket}")
    rows = [pad_length(e, length_bucket, axis=axis) for e in examples]
    while len(rows) < batch_bucket:
        rows.append(rows[0])
    return np.stack(rows, axis=0)

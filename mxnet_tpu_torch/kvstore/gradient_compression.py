"""2-bit gradient compression with error feedback.

Counterpart of ``mxnet_tpu/kvstore/gradient_compression.py`` (reference
``src/kvstore/gradient_compression.cc``), enabled by
``kv.set_gradient_compression({'type': '2bit', 'threshold': t})`` or
``Trainer(compression_params=...)``.  Each gradient element plus its
residual maps to one of {+t, 0, -t} (a 2-bit code: 01 → +t, 10 → -t,
00 → 0); the quantization error accumulates into the residual, and 16
codes pack into one 32-bit word (16× compression of what crosses the
wire).  The codes are torch bit operations on the gradient's device;
the words are kept as int64 holding uint32 values (torch has no uint32
shifts on every device).  The synchronous store quantizes each gradient
before its all-reduce, so every rank sums the values the compressed
hop would deliver.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError


class GradientCompression:
    """Compress, decompress and the residual (reference
    ``GradientCompression``)."""

    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise MXNetError(
                f"unsupported compression type {type!r}; the reference "
                "supports '2bit'")
        if threshold <= 0:
            raise MXNetError("threshold must be positive")
        self.type = type
        self.threshold = float(threshold)

    def compressed_size(self, n):
        """uint32 words for ``n`` values (16 codes a word)."""
        return (n + 15) // 16

    def compress(self, grad, residual=None):
        """→ (packed uint32 words as an int64 NDArray, new residual)."""
        from ..ops.registry import apply_op

        t = self.threshold

        def f(g, r):
            x = g + r
            plus, minus = x >= t, x <= -t
            sent = torch.where(plus, torch.full_like(x, t),
                               torch.where(minus, torch.full_like(x, -t),
                                           torch.zeros_like(x)))
            new_r = x - sent
            codes = (plus.long() + 2 * minus.long()).reshape(-1)
            pad = (-codes.numel()) % 16
            codes = torch.cat([codes, codes.new_zeros(pad)]).reshape(-1, 16)
            shifts = torch.arange(16, device=codes.device) * 2
            return (codes << shifts).sum(dim=1), new_r

        if residual is None:
            from ..ndarray import zeros_like

            residual = zeros_like(grad)
        return apply_op(f, grad, residual, name="gc_compress", no_grad=True)

    def decompress(self, packed, shape):
        """Packed words → the dense f32 gradient of ``shape`` with values
        in {+t, 0, -t}."""
        from ..ops.registry import apply_op

        t = self.threshold
        n = int(np.prod(shape))

        def f(p):
            shifts = torch.arange(16, device=p.device) * 2
            codes = ((p[:, None] >> shifts) & 3).reshape(-1)[:n]
            out = torch.where(codes == 1, torch.tensor(t, device=p.device),
                              torch.where(codes == 2,
                                          torch.tensor(-t, device=p.device),
                                          torch.tensor(0.0, device=p.device)))
            return out.reshape(shape).to(torch.float32)

        return apply_op(f, packed, name="gc_decompress", no_grad=True)

    def roundtrip(self, grad, residual=None):
        """Compress then decompress: the gradient the compressed hop
        delivers, and the new residual."""
        packed, new_r = self.compress(grad, residual)
        return self.decompress(packed, grad.shape), new_r


def create(params):
    """A ``GradientCompression``, or None for empty params (the reference
    needs an explicit ``type``)."""
    params = dict(params or {})
    if "type" not in params:
        if params:
            raise MXNetError(
                "compression_params requires a 'type' key (reference "
                "contract); got " + repr(sorted(params)))
        return None
    ctype = params.pop("type")
    threshold = float(params.pop("threshold", 0.5))
    if params:
        raise MXNetError(f"unknown compression params {sorted(params)}")
    return GradientCompression(type=ctype, threshold=threshold)

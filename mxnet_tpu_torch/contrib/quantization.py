"""Model quantization: calibration and the int8 rewrite of a Gluon net.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (reference
``python/mxnet/contrib/quantization.py`` and
``src/operator/quantization/calibrate.cc``).  ``quantize_net`` is ported
whole: the net runs unhybridized over the calibration batches with a
forward pre-hook on each ``Dense`` and ``Conv2D`` recording its input's
min and max, then each such layer's ``hybrid_forward`` becomes a
``quantize_v2 → quantized_fully_connected/quantized_conv → dequantize``
chain (``ops/quantization.py``) with those ranges as constants, and the
blocks that were hybridized are hybridized again, so the next call
captures the int8 graph.  The KL threshold search of the entropy mode
(``_smooth``, ``_optimal_threshold``) is host numpy, as in the
reference.

``quantize_model``, ``quantize_symbol``, ``quantize_params`` and
``_collect_ranges`` rewrite and run ``Symbol`` graphs: they raise
``MXNetError`` naming ROADMAP.md's Queue 1 item 8f (symbols and export).
"""
from __future__ import annotations

import types

import numpy as np

from ..base import MXNetError

_8F = "is not ported yet (ROADMAP.md, Queue 1 item 8f, symbols and export)"


def _symbolic(name):
    def refuse(*args, **kwargs):
        raise MXNetError(f"contrib.quantization.{name} (a Symbol graph "
                         f"rewrite) {_8F}")

    refuse.__name__ = name
    refuse.__doc__ = (f"Reference ``{name}`` over ``Symbol`` graphs: "
                      "raises, naming Queue 1 item 8f.")
    return refuse


quantize_model = _symbolic("quantize_model")
quantize_symbol = _symbolic("quantize_symbol")
quantize_params = _symbolic("quantize_params")
_collect_ranges = _symbolic("_collect_ranges")


def _smooth(p, eps=1e-4):
    is_zero = p == 0
    n_zero = is_zero.sum()
    n_nonzero = p.size - n_zero
    if n_nonzero == 0:
        return np.full_like(p, eps, dtype=np.float64)
    out = p.astype(np.float64)
    out[is_zero] = eps
    out[~is_zero] -= eps * n_zero / n_nonzero
    # redistribution may push tiny mass negative; keep strictly positive
    return np.maximum(out, eps * 0.1)


def _optimal_threshold(hist, edges, num_quantized_bins=255):
    """KL-divergence threshold search (reference calibrate.cc
    ``GetOptimalThreshold``): the symmetric clip range whose quantized
    distribution diverges least from the float one."""
    hist = hist.astype(np.float64)
    num_bins = hist.size
    zero_bin = num_bins // 2
    best_kl, best_t = np.inf, float(edges[-1])
    for i in range(num_quantized_bins // 2, num_bins // 2 + 1,
                   max((num_bins // 2) // 64, 1)):
        lo, hi = zero_bin - i, zero_bin + i + 1
        sliced = hist[lo:hi]
        # P: the clipped distribution, outliers folded into the edge bins
        p = sliced.copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        if p.sum() == 0:
            continue
        # Q: from the unclipped slice, so a threshold that clips real
        # mass (P's edge spike) is penalized
        factor = sliced.size / num_quantized_bins
        q = np.zeros_like(p, dtype=np.float64)
        for j in range(num_quantized_bins):
            s = int(np.floor(j * factor))
            e = int(np.ceil((j + 1) * factor))
            chunk = sliced[s:e]
            nz = (chunk != 0).sum()
            if nz:
                q[s:e] = np.where(chunk != 0, chunk.sum() / nz, 0)
        ps = _smooth(p / p.sum())
        qs = _smooth(q / max(q.sum(), 1e-12))
        kl = float(np.sum(ps * np.log(ps / qs)))
        if kl < best_kl:
            best_kl = kl
            best_t = float(edges[min(hi, edges.size - 1)])
    return (-best_t, best_t)


def _dense_forward(rng, units, flatten, quantized_dtype):
    def hybrid_forward(self, F, x, weight, bias=None):
        qd = F.quantize_v2(x, out_type=quantized_dtype,
                           min_calib_range=rng[0], max_calib_range=rng[1])
        qw = F.quantize_v2(weight, out_type="int8")
        q = F.quantized_fully_connected(
            qd[0], qw[0], qd[1], qd[2], qw[1], qw[2], no_bias=True,
            num_hidden=units, flatten=flatten)
        out = F.dequantize(q[0], q[1], q[2])
        if bias is not None:
            out = F.broadcast_add(out, bias)
        if self.act is not None:
            out = self.act(out)
        return out
    return hybrid_forward


def _conv_forward(rng, layer):
    def hybrid_forward(self, F, x, weight, bias=None):
        # the conv takes symmetric int8 data (zero padding stays exact)
        qd = F.quantize_v2(x, out_type="int8", min_calib_range=rng[0],
                           max_calib_range=rng[1])
        qw = F.quantize_v2(weight, out_type="int8")
        q = F.quantized_conv(
            qd[0], qw[0], qd[1], qd[2], qw[1], qw[2], no_bias=True,
            kernel=layer._kernel, stride=layer._strides,
            pad=layer._padding, dilate=layer._dilation,
            num_filter=layer._channels)
        out = F.dequantize(q[0], q[1], q[2])
        if bias is not None:
            out = F.broadcast_add(out, F.reshape(bias, shape=(1, -1, 1, 1)))
        if self.act is not None:
            out = self.act(out)
        return out
    return hybrid_forward


def quantize_net(network, quantized_dtype="int8", exclude_layers=None,
                 calib_data=None, data_shapes=None, calib_mode="naive",
                 num_calib_examples=None, ctx=None, **kwargs):
    """Reference ``quantize_net``: quantize a Gluon network in place and
    return it.  Each ``Dense`` and (ungrouped) ``Conv2D`` that ran during
    calibration gets the int8 chain with its calibrated input range;
    ``quantized_dtype`` is the ``Dense`` layers' data type (convs take
    int8).  Calibration is the naive min/max of each layer's input over
    ``calib_data`` (or its first ``num_calib_examples`` rows)."""
    from ..gluon import nn

    if calib_data is None:
        raise MXNetError("quantize_net requires calib_data")
    # a hybridized block replays its graphs and never calls the hooks:
    # calibrate eagerly, hybridize again after the rewrite
    was_hybrid = []

    def _dehybridize(b):
        if getattr(b, "_active", False):
            was_hybrid.append((b, dict(getattr(b, "_flags", {}))))
            b._active = False
        if hasattr(b, "_cached_op"):
            b._cached_op = None

    network.apply(_dehybridize)
    excluded = set(exclude_layers or ())
    targets = []

    def visit(block):
        for child in block._children.values():
            if isinstance(child, (nn.Dense, nn.Conv2D)) and \
                    not getattr(child, "_transposed", False) and \
                    child.name not in excluded:
                targets.append(child)
            visit(child)

    visit(network)
    ranges = {}

    def mk_hook(layer):
        def hook(blk, inputs):
            a = inputs[0].asnumpy()
            mn, mx = float(a.min()), float(a.max())
            if id(layer) in ranges:
                r = ranges[id(layer)]
                ranges[id(layer)] = (min(r[0], mn), max(r[1], mx))
            else:
                ranges[id(layer)] = (mn, mx)
        return hook

    handles = [t.register_forward_pre_hook(mk_hook(t)) for t in targets]
    seen = 0
    for batch in calib_data:
        arrays = batch if isinstance(batch, (list, tuple)) else [batch]
        network(*arrays)
        seen += arrays[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    for h in handles:
        h.detach()

    for t in targets:
        rng = ranges.get(id(t))
        if rng is None:
            continue  # the layer never ran during calibration
        if isinstance(t, nn.Dense):
            fwd = _dense_forward(rng, t._units, t._flatten, quantized_dtype)
        else:
            if getattr(t, "_groups", 1) != 1:
                continue  # a grouped conv stays f32, as in the reference
            fwd = _conv_forward(rng, t)
        t.hybrid_forward = types.MethodType(fwd, t)
        t._cached_op = None
    for b, flags in was_hybrid:
        b._active = True
        b._flags = flags
        b._cached_op = None
    return network

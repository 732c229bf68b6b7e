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

``quantize_model`` is the reference's symbol route: ``_collect_ranges``
runs the f32 graph through an ``Executor`` with a monitor callback
recording each layer's input and output ranges (naive min/max, or
histograms for the entropy mode), then ``quantize_symbol`` rewrites each
``Convolution`` and ``FullyConnected`` node into the same int8 chain and
``quantize_params`` keeps the parameters the new graph still reads.
"""
from __future__ import annotations

import re
import types

import numpy as np

from ..base import MXNetError

_QUANTIZABLE = {"Convolution", "FullyConnected"}


# --- calibration -------------------------------------------------------------

def _collect_ranges(sym, arg_params, aux_params, calib_data, data_names,
                    num_examples, mode, ctx=None):
    """Run fp32 forward passes, recording per-layer output ranges.

    naive: running min/max.  entropy: 8001-bin histograms → KL-optimal
    thresholds (reference calibrate.cc).
    """
    from .. import context as _ctx_mod

    stats = {}      # name -> [min, max]
    hists = {}      # name -> (hist, edges)
    # only quantizable nodes' first inputs are ever consumed as '_input0'
    # keys — skip everything else (weights repeat identically per batch)
    want_inputs = {f"{n.name}_input0" for n in sym._topo()
                   if n.op in _QUANTIZABLE}

    def cb(name, arr):
        # skip input records except quantizable nodes' first inputs
        # (match the generated suffix only — node names may contain
        # '_input' themselves)
        if re.search(r"_input\d+$", name) and name not in want_inputs:
            return
        a = arr.asnumpy()
        mn, mx = float(a.min()), float(a.max())
        if name in stats:
            stats[name][0] = min(stats[name][0], mn)
            stats[name][1] = max(stats[name][1], mx)
        else:
            stats[name] = [mn, mx]
        if mode == "entropy":
            amax = max(abs(mn), abs(mx), 1e-8)
            if name not in hists:
                hists[name] = np.histogram(a, bins=8001,
                                           range=(-amax, amax))
            else:
                h0, e0 = hists[name]
                if e0[-1] >= amax:
                    # existing edges cover the batch: accumulate in place
                    h2, _ = np.histogram(a, bins=8001,
                                         range=(e0[0], e0[-1]))
                    hists[name] = (h0 + h2, e0)
                else:
                    # widen: rebin the old histogram into the new edges
                    h, edges = np.histogram(a, bins=8001,
                                            range=(-amax, amax))
                    h2, _ = np.histogram((e0[:-1] + e0[1:]) / 2, bins=8001,
                                         range=(-amax, amax), weights=h0)
                    hists[name] = (h + h2, edges)

    seen = 0
    first = True
    exe = None
    for batch in calib_data:
        arrays = batch if isinstance(batch, (list, tuple)) else [batch]
        feed = dict(zip(data_names, arrays))
        if first:
            shapes = {k: v.shape for k, v in feed.items()}
            arg_shapes_full = dict(shapes)
            exe = sym.simple_bind(ctx or _ctx_mod.current_context(),
                                  grad_req="null", **arg_shapes_full)
            exe.copy_params_from(arg_params, aux_params)
            exe.set_monitor_callback(cb, monitor_all=True)
            first = False
        exe.forward(is_train=False, **feed)
        seen += arrays[0].shape[0]
        if num_examples is not None and seen >= num_examples:
            break
    if mode == "entropy":
        return {n: _optimal_threshold(*hists[n]) for n in hists}
    return {n: (mn, mx) for n, (mn, mx) in stats.items()}


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


# --- graph rewrite -----------------------------------------------------------

def _int8_supported(node):
    """quantized_conv covers plain 2D convs only — grouped and 1D/3D
    convolutions stay fp32 (the reference excludes these per-backend via
    the same node-level check in its quantize pass)."""
    if node.op != "Convolution":
        return True
    if int(node.attrs.get("num_group", 1)) != 1:
        return False
    kernel = node.attrs.get("kernel")
    return kernel is None or len(tuple(kernel)) == 2


def _producer_range(node, calib_ranges):
    """Calibrated range of the tensor feeding ``node`` (the producing
    layer's recorded output range)."""
    if not node.inputs:
        return None
    src, oi = node.inputs[0]
    suffix = f"_output{oi}" if src.num_outputs > 1 else "_output"
    return calib_ranges.get(src.name + suffix)


def quantize_symbol(sym, excluded_sym_names=(), offline_params=(),
                    calib_ranges=None, quantized_dtype="int8",
                    param_shapes=None):
    """Rewrite a Symbol: quantizable nodes become int8 chains (reference
    ``QuantizeGraph`` pass, ``src/operator/quantization/
    quantize_graph_pass.cc``).  ``param_shapes`` are baked into the new
    graph's vars — a param that used to feed an FC/Conv (whose inference
    rule derived its shape) now feeds ``quantize_v2``, which can't."""
    from .. import symbol as S

    calib_ranges = calib_ranges or {}
    param_shapes = param_shapes or {}
    excluded = set(excluded_sym_names)
    cache = {}

    def convert(node, oidx):
        key = (id(node), oidx)
        if key in cache:
            return cache[key]
        if node.is_var():
            out = S.var(node.name,
                        shape=param_shapes.get(node.name),
                        attr=({"__is_aux__": True}
                              if node.attrs.get("__is_aux__") else None))
            cache[(id(node), 0)] = out
            return out
        ins = [convert(s, oi) for s, oi in node.inputs]
        attrs = {k: v for k, v in node.attrs.items()
                 if not k.startswith("__")}
        if node.op in _QUANTIZABLE and node.name not in excluded and \
                _int8_supported(node):
            data, weight = ins[0], ins[1]
            no_bias = str(attrs.get("no_bias", False)).lower() in \
                ("true", "1")
            bias = None if no_bias else ins[2]
            # calibrated range of THIS layer's input: prefer the directly
            # recorded input range (monitor_all), else the producer's
            # output range
            rng = calib_ranges.get(f"{node.name}_input0") \
                or _producer_range(node, calib_ranges)
            qkw = {}
            if rng is not None:
                qkw = {"min_calib_range": float(rng[0]),
                       "max_calib_range": float(rng[1])}
            # conv requires symmetric int8 data (zero-padding exactness)
            ddtype = "int8" if node.op == "Convolution" else quantized_dtype
            qd = S.quantize_v2(data, out_type=ddtype,
                               name=f"{node.name}_data_quantize", **qkw)
            qw = S.quantize_v2(weight, out_type="int8",
                               name=f"{node.name}_weight_quantize")
            # int8 compute without bias; fp32 bias added after dequantize
            # (exact — avoids requantizing bias into the accum scale)
            qargs = [qd[0], qw[0], qd[1], qd[2], qw[1], qw[2]]
            qop = (S.quantized_conv if node.op == "Convolution"
                   else S.quantized_fully_connected)
            q = qop(*qargs, name=f"quantized_{node.name}", no_bias=True,
                    **{k: v for k, v in attrs.items() if k != "no_bias"})
            out = S.dequantize(q[0], q[1], q[2],
                               name=f"{node.name}_dequantize")
            if bias is not None:
                if node.op == "Convolution":
                    b = S.reshape(bias, shape=(1, -1, 1, 1),
                                  name=f"{node.name}_bias_reshape")
                else:
                    b = bias
                out = S.broadcast_add(out, b, name=f"{node.name}_bias_add")
            cache[key] = out
            return out
        from ..symbol.symbol import Symbol, _sym_op as _builder

        built = _builder(node.op)(*ins, name=node.name, **attrs)
        # every output of the rebuilt node, the hidden ones too
        # (BatchNorm shows 1 of its 3; the reference indexes the visible
        # heads and fails on a graph with a BatchNorm)
        new = built._heads[0][0]
        for i in range(node.num_outputs):
            cache[(id(node), i)] = Symbol([(new, i)])
        return cache[key]

    heads = [convert(n, oi) for n, oi in sym._heads]
    return S.Group(heads) if len(heads) > 1 else heads[0]


def quantize_params(qsym, arg_params):
    """Pass-through params for vars still present in the quantized graph
    (weights stay fp32 here; quantize_v2 nodes quantize at bind time —
    the reference's offline variant precomputes int8 copies instead)."""
    needed = set(qsym.list_arguments()) | set(qsym.list_auxiliary_states())
    return {k: v for k, v in arg_params.items() if k in needed}


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=None, calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", **kwargs):
    """Reference ``mx.contrib.quantization.quantize_model``: returns
    (quantized symbol, params, aux params)."""
    if quantized_dtype not in ("int8", "uint8", "auto"):
        raise MXNetError(f"bad quantized_dtype {quantized_dtype!r}")
    if quantized_dtype == "auto":
        quantized_dtype = "int8"
    ranges = None
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError(
                f"calib_mode={calib_mode!r} requires calib_data")
        ranges = _collect_ranges(sym, arg_params, aux_params, calib_data,
                                 data_names, num_calib_examples,
                                 calib_mode, ctx=ctx)
    qsym = quantize_symbol(sym, excluded_sym_names or (),
                           calib_ranges=ranges,
                           quantized_dtype=quantized_dtype,
                           param_shapes={k: v.shape
                                         for k, v in arg_params.items()})
    qarg = quantize_params(qsym, arg_params)
    return qsym, qarg, dict(aux_params or {})


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

"""Symbol graph → ONNX ModelProto exporter.

Counterpart of ``mxnet_tpu/contrib/onnx/mx2onnx.py`` (reference
``python/mxnet/contrib/onnx/mx2onnx/export_model.py`` and
``_op_translations.py``) — per-op translation table from the nnvm graph
to ONNX nodes.  Here the walk runs over the native Symbol
node graph and the bytes are produced by the wire-format encoder in
``_proto.py`` (no ``onnx`` package dependency); opset 13.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from . import _proto as P

_OPSET = 13
_IR_VERSION = 8


def _tensor(name, arr):
    shape = np.shape(arr)
    # ascontiguousarray promotes 0-d to (1,) on NumPy 2.x — restore the
    # true rank (ONNX requires e.g. Clip bounds to be rank-0)
    arr = np.ascontiguousarray(arr).reshape(shape)
    dt = {np.dtype(np.float32): P.FLOAT, np.dtype(np.float64): P.DOUBLE,
          np.dtype(np.int64): P.INT64, np.dtype(np.int32): P.INT32,
          np.dtype(np.int8): P.INT8, np.dtype(np.uint8): P.UINT8,
          np.dtype(np.float16): P.FLOAT16}.get(arr.dtype)
    if dt is None:
        raise MXNetError(f"unsupported dtype {arr.dtype} for ONNX export")
    body = b"".join(P.fint(1, d) for d in arr.shape)
    body += P.fint(2, dt)
    body += P.fstr(8, name)
    body += P.fbytes(9, arr.tobytes())          # raw_data
    return body


def _value_info(name, shape, elem_type=P.FLOAT):
    dims = b"".join(P.fbytes(1, P.fint(1, int(d))) for d in shape)
    tensor_type = P.fint(1, elem_type) + P.fbytes(2, dims)
    type_proto = P.fbytes(1, tensor_type)
    return P.fstr(1, name) + P.fbytes(2, type_proto)


def _attr(name, value):
    body = P.fstr(1, name)
    if isinstance(value, float):
        body += P.ffloat(2, value) + P.fint(20, P.ATTR_FLOAT)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        body += P.fint(3, int(value)) + P.fint(20, P.ATTR_INT)
    elif isinstance(value, str):
        body += P.fbytes(4, value.encode()) + P.fint(20, P.ATTR_STRING)
    elif isinstance(value, np.ndarray):
        body += P.fbytes(5, _tensor(name, value)) + \
            P.fint(20, P.ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        body += P.fpacked_ints(8, value) + P.fint(20, P.ATTR_INTS)
    else:
        raise MXNetError(f"unsupported attribute {name}={value!r}")
    return body


def _const(out, arr):
    """Constant node carrying ``arr`` as its value tensor — used by the
    decomposed NLP exports (LayerNorm eps, GELU constants, Reshape
    shapes, Slice indices)."""
    return _node("Constant", [], [out], out,
                 {"value": np.asarray(arr)})


def _node(op_type, inputs, outputs, name, attrs=None):
    body = b"".join(P.fstr(1, i) for i in inputs)
    body += b"".join(P.fstr(2, o) for o in outputs)
    body += P.fstr(3, name)
    body += P.fstr(4, op_type)
    for k, v in (attrs or {}).items():
        body += P.fbytes(5, _attr(k, v))
    return body


def _tup(v, n, default):
    """Normalize kernel/stride/pad attrs to rank ``n`` (same defaults as
    the runtime ops: stride/dilate → 1, pad → 0)."""
    if v is None:
        return (default,) * n
    t = tuple(int(x) for x in (v if isinstance(v, (list, tuple)) else
                               (v,) * n))
    if len(t) != n:
        raise MXNetError(f"attribute rank {len(t)} != spatial rank {n}")
    return t


# --- per-op translations ----------------------------------------------------

def _kernel_attr(attrs, op):
    """Kernel rank drives every other spatial attr.  The runtime derives
    rank from the DATA shape for scalar/missing kernels; export has no
    shapes, so both cases need an explicit tuple — fail clearly."""
    k = attrs.get("kernel")
    if k is None or isinstance(k, (int, np.integer)):
        raise MXNetError(
            f"ONNX export: {op} needs an explicit kernel tuple, e.g. "
            f"kernel=(3, 3) (got {k!r}; the runtime infers spatial rank "
            "from data shapes, export cannot)")
    return tuple(int(x) for x in k)


def _conv(node, ins, out, attrs):
    kernel = _kernel_attr(attrs, "Convolution")
    n = len(kernel)
    stride = _tup(attrs.get("stride"), n, 1)
    pad = _tup(attrs.get("pad"), n, 0)
    dil = _tup(attrs.get("dilate"), n, 1)
    a = {"kernel_shape": kernel, "strides": stride,
         "pads": pad + pad, "dilations": dil,
         "group": int(attrs.get("num_group", 1))}
    return [_node("Conv", ins, [out], out, a)]


def _fc(node, ins, out, attrs):
    flatten = str(attrs.get("flatten", True)).lower() != "false"
    nodes = []
    data = ins[0]
    if flatten:
        nodes.append(_node("Flatten", [data], [out + "_flat"],
                           out + "_flatten", {"axis": 1}))
        data = out + "_flat"
    gemm_ins = [data, ins[1]] + ins[2:]
    nodes.append(_node("Gemm", gemm_ins, [out], out,
                       {"alpha": 1.0, "beta": 1.0, "transA": 0,
                        "transB": 1}))
    return nodes


_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus", "softsign": "Softsign"}


def _activation(node, ins, out, attrs):
    act = attrs.get("act_type", "relu")
    if act not in _ACT:
        raise MXNetError(f"ONNX export: unsupported act_type {act!r}")
    return [_node(_ACT[act], ins[:1], [out], out)]


def _bn(node, ins, out, attrs):
    # mxnet order: data gamma beta moving_mean moving_var (matches ONNX)
    return [_node("BatchNormalization", ins[:5], [out], out,
                  {"epsilon": float(attrs.get("eps", 1e-5)),
                   "momentum": float(attrs.get("momentum", 0.9))})]


def _pool(node, ins, out, attrs):
    ptype = attrs.get("pool_type", "max")
    if str(attrs.get("global_pool", False)).lower() in ("true", "1"):
        op = "GlobalAveragePool" if ptype == "avg" else "GlobalMaxPool"
        return [_node(op, ins[:1], [out], out)]
    kernel = _kernel_attr(attrs, "Pooling")
    n = len(kernel)
    stride = _tup(attrs.get("stride"), n, 1)
    pad = _tup(attrs.get("pad"), n, 0)
    op = "AveragePool" if ptype == "avg" else "MaxPool"
    return [_node(op, ins[:1], [out], out,
                  {"kernel_shape": kernel, "strides": stride,
                   "pads": pad + pad})]


def _simple(onnx_op, n_in=1):
    def conv(node, ins, out, attrs):
        return [_node(onnx_op, ins[:n_in], [out], out)]
    return conv


def _softmax(node, ins, out, attrs):
    return [_node("Softmax", ins[:1], [out], out,
                  {"axis": int(attrs.get("axis", -1))})]


def _concat(node, ins, out, attrs):
    return [_node("Concat", ins, [out], out,
                  {"axis": int(attrs.get("dim", 1))})]


def _dropout(node, ins, out, attrs):
    return [_node("Identity", ins[:1], [out], out)]  # inference export


def _elemwise(onnx_op):
    def conv(node, ins, out, attrs):
        return [_node(onnx_op, ins[:2], [out], out)]
    return conv


# --- NLP subset (round 4): LayerNorm/GELU/attention building blocks ---------

def _layer_norm(node, ins, out, attrs):
    """Opset-13 decomposition (LayerNormalization is opset 17):
    (x - mean) / sqrt(var + eps) * gamma + beta over the last axis."""
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("eps", 1e-5))
    x, g, b = ins[0], ins[1], ins[2]

    def n(s):
        return f"{out}__{s}"

    return [
        _node("ReduceMean", [x], [n("mu")], n("mu"),
              {"axes": [axis], "keepdims": 1}),
        _node("Sub", [x, n("mu")], [n("d")], n("d")),
        _node("Mul", [n("d"), n("d")], [n("d2")], n("d2")),
        _node("ReduceMean", [n("d2")], [n("var")], n("var"),
              {"axes": [axis], "keepdims": 1}),
        _const(n("eps"), np.float32(eps)),
        _node("Add", [n("var"), n("eps")], [n("ve")], n("ve")),
        _node("Sqrt", [n("ve")], [n("std")], n("std")),
        _node("Div", [n("d"), n("std")], [n("norm")], n("norm")),
        _node("Mul", [n("norm"), g], [n("sc")], n("sc")),
        _node("Add", [n("sc"), b], [out], out),
    ]


def _leaky_relu(node, ins, out, attrs):
    act = attrs.get("act_type", "leaky")
    x = ins[0]

    def n(s):
        return f"{out}__{s}"

    if act == "leaky":
        return [_node("LeakyRelu", [x], [out], out,
                      {"alpha": float(attrs.get("slope", 0.25))})]
    if act == "elu":
        # runtime default slope is 0.25 (LeakyReLU family default), NOT
        # ONNX Elu's 1.0 — exporting the wrong default is 4x off on
        # every negative value
        return [_node("Elu", [x], [out], out,
                      {"alpha": float(attrs.get("slope", 0.25))})]
    if act == "gelu":
        # exact erf form: 0.5 x (1 + erf(x / sqrt(2)))
        return [
            _const(n("rsqrt2"), np.float32(1.0 / np.sqrt(2.0))),
            _node("Mul", [x, n("rsqrt2")], [n("xs")], n("xs")),
            _node("Erf", [n("xs")], [n("erf")], n("erf")),
            _const(n("one"), np.float32(1.0)),
            _node("Add", [n("erf"), n("one")], [n("e1")], n("e1")),
            _node("Mul", [x, n("e1")], [n("xe")], n("xe")),
            _const(n("half"), np.float32(0.5)),
            _node("Mul", [n("xe"), n("half")], [out], out),
        ]
    raise MXNetError(f"ONNX export: unsupported LeakyReLU act {act!r}")


def _embedding(node, ins, out, attrs):
    # mx Embedding(data, weight) -> Gather(weight, int64(data)).
    # The runtime CLIPS ids to [0, input_dim-1] (nn_ops.embedding);
    # a bare Gather instead wraps negatives from the end and errors on
    # overflow in external runtimes — export the clip explicitly.
    input_dim = attrs.get("input_dim")
    if input_dim is None:
        raise MXNetError(
            "ONNX export: Embedding needs input_dim to export the "
            "runtime's id-clipping semantics")

    def n(s):
        return f"{out}__{s}"

    return [
        _node("Cast", [ins[0]], [n("ids")], n("ids"), {"to": P.INT64}),
        _const(n("lo"), np.asarray(0, np.int64)),
        _const(n("hi"), np.asarray(int(input_dim) - 1, np.int64)),
        _node("Clip", [n("ids"), n("lo"), n("hi")], [n("cl")], n("cl")),
        _node("Gather", [ins[1], n("cl")], [out], out, {"axis": 0}),
    ]


def _batch_dot(node, ins, out, attrs):
    ta = str(attrs.get("transpose_a", False)).lower() in ("true", "1")
    tb = str(attrs.get("transpose_b", False)).lower() in ("true", "1")
    if ta or tb:
        raise MXNetError(
            "ONNX export: batch_dot transpose flags need the operand "
            "rank (unknown at export) — insert an explicit transpose "
            "before batch_dot instead")
    return [_node("MatMul", ins[:2], [out], out)]


def _transpose_exp(node, ins, out, attrs):
    axes = attrs.get("axes")
    a = {} if axes in (None, "None", ()) else \
        {"perm": [int(x) for x in axes]}
    return [_node("Transpose", ins[:1], [out], out, a)]


def _reshape_exp(node, ins, out, attrs):
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    if any(s in (0, -2, -3, -4) for s in shape):
        raise MXNetError(
            "ONNX export: mx reshape special codes (0/-2/-3/-4) "
            f"unsupported, got {shape}")
    return [
        _const(out + "__shape", np.asarray(shape, np.int64)),
        _node("Reshape", [ins[0], out + "__shape"], [out], out),
    ]


def _slice_axis_exp(node, ins, out, attrs):
    axis = int(attrs.get("axis", 0))
    begin = int(attrs.get("begin", 0))
    end = attrs.get("end")
    end = 2 ** 62 if end in (None, "None") else int(end)
    return [
        _const(out + "__st", np.asarray([begin], np.int64)),
        _const(out + "__en", np.asarray([end], np.int64)),
        _const(out + "__ax", np.asarray([axis], np.int64)),
        _node("Slice", [ins[0], out + "__st", out + "__en",
                        out + "__ax"], [out], out),
    ]


def _expand_dims_exp(node, ins, out, attrs):
    return [
        _const(out + "__ax",
               np.asarray([int(attrs.get("axis", 0))], np.int64)),
        _node("Unsqueeze", [ins[0], out + "__ax"], [out], out),
    ]


def _where_exp(node, ins, out, attrs):
    return [
        _node("Cast", [ins[0]], [out + "__c"], out + "__c",
              {"to": P.BOOL}),
        _node("Where", [out + "__c", ins[1], ins[2]], [out], out),
    ]


_TRANSLATIONS = {
    "Convolution": _conv,
    "FullyConnected": _fc,
    "Activation": _activation,
    "BatchNorm": _bn,
    "batch_norm": _bn,
    "Pooling": _pool,
    "Flatten": lambda n, i, o, a: [_node("Flatten", i[:1], [o], o,
                                         {"axis": 1})],
    "softmax": _softmax,
    "log_softmax": lambda n, i, o, a: [_node("LogSoftmax", i[:1], [o], o)],
    "Concat": _concat,
    "concat": _concat,
    "Dropout": _dropout,
    "dropout": _dropout,
    "relu": _simple("Relu"),
    "sigmoid": _simple("Sigmoid"),
    "tanh": _simple("Tanh"),
    "exp": _simple("Exp"),
    "log": _simple("Log"),
    "sqrt": _simple("Sqrt"),
    "elemwise_add": _elemwise("Add"),
    "add": _elemwise("Add"),
    "broadcast_add": _elemwise("Add"),
    "elemwise_mul": _elemwise("Mul"),
    "mul": _elemwise("Mul"),
    "broadcast_mul": _elemwise("Mul"),
    "elemwise_sub": _elemwise("Sub"),
    "sub": _elemwise("Sub"),
    # NLP subset (round 4) — enough for a transformer encoder layer:
    "LayerNorm": _layer_norm,
    "layer_norm": _layer_norm,
    "LeakyReLU": _leaky_relu,
    "leaky_relu": _leaky_relu,
    "erf": _simple("Erf"),
    "Embedding": _embedding,
    "embedding": _embedding,
    "batch_dot": _batch_dot,
    "transpose": _transpose_exp,
    "Reshape": _reshape_exp,
    "reshape": _reshape_exp,
    "slice_axis": _slice_axis_exp,
    "expand_dims": _expand_dims_exp,
    "where": _where_exp,
    "broadcast_div": _elemwise("Div"),
    "div": _elemwise("Div"),
    "broadcast_sub": _elemwise("Sub"),
    "broadcast_power": _elemwise("Pow"),
    "broadcast_maximum": _elemwise("Max"),
    "broadcast_minimum": _elemwise("Min"),
    "maximum": _elemwise("Max"),
    "minimum": _elemwise("Min"),
}


def _scalar_op(onnx_op, reverse=False):
    """Scalar-arithmetic family (x op c, and c op x for the _r
    variants).  The constant is emitted in the TRACKED dtype of the
    tensor operand (export_model threads it via the private
    ``_onnx_in_dtype`` attr) so non-float32 graphs don't produce
    type-mismatched binary ops that strict runtimes reject.  Integer
    operands get a Cast-to-float32 mirroring the runtime's promotion
    (the scalar passes through float(), so e.g. int32/2 is TRUE
    division at runtime — an int ONNX Div would truncate)."""
    def conv(node, ins, out, attrs):
        dt = np.dtype(attrs.get("_onnx_in_dtype") or np.float32)
        val = float(attrs.get("scalar", 0.0))
        c = out + "__s"
        nodes = []
        data = ins[0]
        if np.issubdtype(dt, np.integer):
            # mirror the RUNTIME semantics: the scalar goes through
            # float(), so an integer tensor promotes to float32 (true
            # division included) — export a Cast, not an int constant
            # (ONNX integer Div truncates; the runtime's never does)
            data = out + "__f"
            nodes.append(_node("Cast", [ins[0]], [data], data,
                               {"to": P.FLOAT}))
            dt = np.dtype(np.float32)
        const = np.asarray(val, dtype=dt)
        operands = [c, data] if reverse else [data, c]
        nodes.append(_const(c, const))
        nodes.append(_node(onnx_op, operands, [out], out))
        return nodes
    return conv


_SCALAR_OPS = ("_mul_scalar", "_div_scalar", "_plus_scalar",
               "_minus_scalar", "_rminus_scalar", "_rdiv_scalar")

_TRANSLATIONS.update({
    "_mul_scalar": _scalar_op("Mul"),
    "_div_scalar": _scalar_op("Div"),
    "_plus_scalar": _scalar_op("Add"),
    "_minus_scalar": _scalar_op("Sub"),
    "_rminus_scalar": _scalar_op("Sub", reverse=True),
    "_rdiv_scalar": _scalar_op("Div", reverse=True),
})


_NP2ONNX = {"float32": P.FLOAT, "float64": P.DOUBLE, "int64": P.INT64,
            "int32": P.INT32, "int8": P.INT8, "uint8": P.UINT8,
            "float16": P.FLOAT16}


def export_model(sym, params, input_shapes, input_types=None,
                 onnx_file_path="model.onnx", verbose=False):
    """Reference ``mx.contrib.onnx.export_model``: Symbol + params →
    ONNX file.  ``input_shapes``/``input_types``: per data input
    (non-param vars, graph order; types default float32)."""
    params = dict({k.split(":", 1)[-1]: v for k, v in params.items()})
    # fix_gamma BatchNorms compute with gamma == 1 (runtime contract,
    # ops/nn_ops.py batch_norm); the exported initializer must match
    for node in sym._topo():
        if node.op in ("BatchNorm", "batch_norm") and \
                str(node.attrs.get("fix_gamma", True)).lower() in \
                ("true", "1"):
            if len(node.inputs) > 1:
                gname = node.inputs[1][0].name
                if gname in params:
                    params[gname] = params[gname] * 0 + 1  # ones_like
    # output shapes/dtypes for the declared ValueInfos
    try:
        shape_kwargs = {}
        di = 0
        for node in sym._topo():
            if node.is_var() and node.name not in params:
                shape_kwargs[node.name] = tuple(input_shapes[di])
                di += 1
        _, out_shapes, _ = sym.infer_shape(**shape_kwargs)
    except Exception:
        out_shapes = [() for _ in sym._heads]
    order = sym._topo()
    names = {}           # (id(node), oidx) -> onnx tensor name
    tdtypes = {}         # onnx tensor name -> np.dtype (best effort)
    nodes_out = []
    initializers = []
    graph_inputs = []
    data_idx = 0

    for node in order:
        if node.is_var():
            names[(id(node), 0)] = node.name
            if node.name in params:
                arr = np.asarray(params[node.name].asnumpy())
                tdtypes[node.name] = arr.dtype
                initializers.append(_tensor(node.name, arr))
            else:
                if data_idx >= len(input_shapes):
                    raise MXNetError(
                        f"no input shape provided for {node.name!r}")
                et = P.FLOAT
                tdtypes[node.name] = np.dtype(np.float32)
                if input_types is not None and data_idx < len(input_types):
                    dt = np.dtype(input_types[data_idx])
                    et = _NP2ONNX.get(dt.name, P.FLOAT)
                    tdtypes[node.name] = dt
                graph_inputs.append(
                    _value_info(node.name, input_shapes[data_idx], et))
                data_idx += 1
            continue
        trans = _TRANSLATIONS.get(node.op)
        if trans is None:
            raise MXNetError(
                f"ONNX export: op {node.op!r} has no translation "
                f"(supported: {sorted(_TRANSLATIONS)})")
        ins = [names[(id(s), oi)] for s, oi in node.inputs]
        out_name = node.name
        for i in range(node.num_outputs):
            names[(id(node), i)] = out_name if i == 0 else \
                f"{out_name}_out{i}"
        attrs = {k: v for k, v in node.attrs.items()
                 if not k.startswith("__")}
        # dtype flow for the translators that need it (_scalar_op): the
        # lookup result dtype follows the table, `where` follows its
        # branches (the condition is Cast to BOOL), everything else in
        # the subset follows its first dtype-known input
        if node.op in ("Embedding", "embedding", "where") and len(ins) > 1:
            out_dt = tdtypes.get(ins[1])
        else:
            out_dt = next((tdtypes[i] for i in ins if i in tdtypes), None)
        if out_dt is not None:
            attrs["_onnx_in_dtype"] = out_dt
            if node.op in _SCALAR_OPS and np.issubdtype(out_dt,
                                                        np.integer):
                # the runtime promotes int scalar-arithmetic to float32
                # (scalar passes through float()); the emitted Cast in
                # _scalar_op makes the exported output f32 too
                out_dt = np.dtype(np.float32)
            for i in range(node.num_outputs):
                tdtypes[names[(id(node), i)]] = out_dt
        nodes_out.extend(trans(node, ins, out_name, attrs))

    outputs = [_value_info(names[(id(n), oi)], shp or ())
               for (n, oi), shp in zip(sym._heads, out_shapes)]
    graph = b"".join(P.fbytes(1, nb) for nb in nodes_out)
    graph += P.fstr(2, "mxnet_tpu_exported")
    graph += b"".join(P.fbytes(5, t) for t in initializers)
    graph += b"".join(P.fbytes(11, vi) for vi in graph_inputs)
    graph += b"".join(P.fbytes(12, vo) for vo in outputs)

    opset = P.fint(2, _OPSET)  # default domain ""
    model = P.fint(1, _IR_VERSION)
    model += P.fstr(2, "mxnet_tpu")
    model += P.fstr(3, "0.1")
    model += P.fbytes(7, graph)
    model += P.fbytes(8, opset)

    with open(onnx_file_path, "wb") as f:
        f.write(model)
    if verbose:
        print(f"wrote {onnx_file_path}: {len(nodes_out)} nodes, "
              f"{len(initializers)} initializers")
    return onnx_file_path
